
import os, pathlib, sys, time
REPO = str(pathlib.Path(__file__).resolve().parents[1])
sys.path.insert(0, REPO)
# CPU only, on purpose: several workers run at once, and none may open a
# GPU (a JAX process reserves most of a card's memory when it starts).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax
jax.config.update("jax_platforms", "cpu")
nproc = int(sys.argv[1]); pid = int(sys.argv[2]); port = sys.argv[3]
if nproc > 1:
    jax.distributed.initialize(coordinator_address="localhost:" + port,
                               num_processes=nproc, process_id=pid)
import numpy as np, jax.numpy as jnp
import __graft_entry__ as ge
from lightdock_tpu.parallel.farm import SwarmFarmRunner

params, pos, _ = ge._toy_system(n_rec=300, n_lig=100, g=50)
S = 2 * len(jax.devices())   # 2 swarms per global device
runner = SwarmFarmRunner(params, [pos] * S, list(range(S)), seed=324324,
                         use_anm=False, anm_rec=0, anm_lig=0,
                         dtype=jnp.float32, output_root=None,
                         energy_mode="xla")
def fetch():
    # Force completion via process-LOCAL shards (a global sharded array
    # spanning both processes cannot be np.asarray'd directly).
    arr = jax.tree_util.tree_leaves(runner.states)[0]
    for s in arr.addressable_shards:
        np.asarray(s.data)

states0 = runner.states
runner.run_segmented(30, segment=30)   # compile+warm
fetch()
best = 1e9
for _ in range(3):
    runner._start_step, runner.states = 0, states0
    t0 = time.time()
    runner.run_segmented(30, segment=30)
    fetch()
    best = min(best, time.time() - t0)
poses = S * 50 * 30
print("WORKER_RESULT", pid, poses / best / len(jax.devices()), flush=True)
if nproc > 1:
    jax.distributed.shutdown()
