"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never picks the CPU on its own."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import exciting_environments_torch as P

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import exciting_environments_torch, exciting_environments_torch.ops.kernels.stepper\n"
        "import exciting_environments_torch.models.pmsm, exciting_environments_torch.ops.kernels.pmsm_stepper\n"
        "import exciting_environments_torch.utils.convert\n"
        "import exciting_environments_torch.ops.kernels.closed_loop, exciting_environments_torch.ops.policies\n"
        "import exciting_environments_torch.utils.rl_fused, exciting_environments_torch.utils.collect\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'exciting_environments_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("name", ["Pendulum", "CartPole", "MassSpringDamper", "PMSM"])
def test_default_device_is_cuda_and_never_falls_back(name):
    cls = getattr(P, name)
    if torch.cuda.is_available():
        assert cls(batch_size=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(batch_size=2)
    assert cls(batch_size=2, device="cpu").device.type == "cpu"
