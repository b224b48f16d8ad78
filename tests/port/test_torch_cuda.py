"""K1-K6 CUDA kernels against their plain PyTorch versions on the card, at a
small size (marked `cuda`; skips without a GPU). `chip_smoke.py` runs the
same checks at the main path's 256^3 shapes."""

import numpy as np
import pytest
import torch

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.radiation import sweep as rsweep

from torch_port_common import BC_KINDS, jax_opts, make_state, port_opts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("bc_name", sorted(BC_KINDS))
def test_kernels_match_plain(cuda_device, bc_name):
    n = 16
    U = torch.tensor(make_state((n, n, n), seed=5, rough=True), dtype=torch.float32,
                     device=cuda_device)
    U2 = torch.tensor(make_state((n, n, n), seed=6), dtype=torch.float32,
                      device=cuda_device)
    sweep.reset_launch_counts()
    for case in kernel_check.cases(U, U2, port_opts(jax_opts(n)), BC_KINDS[bc_name],
                                   0.2 / n):
        ok, max_abs, _ = kernel_check.compare(case.run_kernel(), case.run_plain())
        assert ok, (case.label, max_abs)
    assert all(sweep.launch_counts[k] > 0 for k in ("transverse", "axis_flux", "apply_update"))
    assert np.isfinite(max_abs)


@pytest.mark.parametrize("opacity,rough", [("bench", False), ("tdep", True)])
def test_rad_kernels_match_plain(cuda_device, opacity, rough):
    from test_torch_rad_kernels import (DT, DX, EOS, make_rad_state, port_opts,
                                        port_problem, jax_opts)

    U = torch.tensor(make_rad_state(seed=21, rough=rough), dtype=torch.float32,
                     device=cuda_device)
    rsweep.reset_launch_counts()
    for case in kernel_check.rad_cases(U, None, float(np.float32(DT)), port_opts(jax_opts()),
                                       EOS, port_problem(opacity), (DX,) * 3):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)
    assert all(v > 0 for v in rsweep.launch_counts.values())
