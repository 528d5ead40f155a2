"""Checks that need an NVIDIA GPU: the compiled DFIRE kernel at real
widths, and TF32 exactness of the bias einsums.  chip_smoke.py runs the
same checks (phase k).

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import pytest

import chip_smoke as cs
from lightdock_tpu import synthetic

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    out = {}
    for name in ("1ppe", "2uuy", "1k4c"):
        inputs = synthetic.make_complex(name, tmp_path_factory.mktemp(name),
                                        swarms=1)
        out[name] = synthetic.load(inputs)
    return out


@pytest.mark.parametrize("name", ["1ppe", "2uuy", "1k4c"])
def test_kernel_compiled_matches_interpret_xla_and_oracle(gpu, sims, name):
    errs = cs.check_kernel_compiled(sims[name], 16,
                                    interpret_check=name != "1k4c")
    assert set(errs) >= {"kernel", "xla-gather", "kernel-vs-xla-gather"}


def test_bias_einsums_exact_in_tf32(gpu, sims):
    assert cs.check_bias_precision(sims["1k4c"])
