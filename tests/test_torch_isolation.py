"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never picks the CPU on its own."""

import os
import re
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
        "import exciting_environments_torch.ops.kernels.pmsm_closed_loop, exciting_environments_torch.utils.foc\n"
        "import exciting_environments_torch.ops.fastmath, exciting_environments_torch.ops.pmsm_fast\n"
        "import exciting_environments_torch.ops.kernels.pendulum_fast\n"
        "import exciting_environments_torch.ops.kernels.pmsm_fast_kernel, exciting_environments_torch.ops.random\n"
        "import exciting_environments_torch.utils.episodes, exciting_environments_torch.utils.rl\n"
        "import exciting_environments_torch.utils.sac, exciting_environments_torch.utils.train\n"
        "import exciting_environments_torch.ops.signals, exciting_environments_torch.utils.randomize\n"
        "import exciting_environments_torch.ops.adaptive, exciting_environments_torch.utils.estimate\n"
        "import exciting_environments_torch.utils.mpc, exciting_environments_torch.utils.ofc\n"
        "import exciting_environments_torch.utils.ilqr, exciting_environments_torch.utils.sysid\n"
        "import exciting_environments_torch.utils.checkpoint, exciting_environments_torch.utils.profiling\n"
        "import exciting_environments_torch.parallel, exciting_environments_torch.parallel.mesh\n"
        "import exciting_environments_torch.parallel.metrics, exciting_environments_torch.wrappers.gym\n"
        "import exciting_environments_torch.wrappers.gymnasium_vector, exciting_environments_torch.wrappers.mujoco\n"
        "import exciting_environments_torch.utils.fleet, exciting_environments_torch.io\n"
        "import exciting_environments_torch.io.dataset, exciting_environments_torch.io.loader\n"
        "import exciting_environments_torch.io.native, exciting_environments_torch.io.torch_data\n"
        "import exciting_environments_torch.io.__main__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'exciting_environments_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


CSRC = ROOT / "exciting_environments_torch" / "csrc"
#: the shared device headers each kernel source builds on
HEADERS = {
    "stepper.cu": ("action_ring.cuh", "classic_envs.cuh", "eager_rules.cuh"),
    "closed_loop.cu": ("classic_envs.cuh", "eager_rules.cuh", "foc_laws.cuh", "policy_laws.cuh"),
    "pmsm_stepper.cu": ("eager_rules.cuh", "pmsm_drive.cuh"),
    "pmsm_closed_loop.cu": ("eager_rules.cuh", "pmsm_drive.cuh", "policy_laws.cuh"),
    "pendulum_fast.cu": ("action_ring.cuh", "eager_rules.cuh", "fastmath.cuh"),
    "pmsm_fast.cu": ("eager_rules.cuh", "fastmath.cuh", "pmsm_drive.cuh"),
    # the closed loop's adjoint recomputes each step with the forward kernel's own functions
    "pmsm_closed_loop_adjoint.cu": ("pmsm_closed_loop.cuh",),
    "pmsm_angles.cu": ("eager_rules.cuh",),
}


@pytest.mark.parametrize("source", sorted(HEADERS))
def test_kernel_sources_share_their_headers_and_stand_alone(source):
    """Each kernel includes the shared headers (one gather, one affine law, one action ring),
    defines no copy of what they hold, and includes no PyTorch header (the
    libraries have a plain C interface, loaded with ctypes).  A library split
    into translation units (``<name>.cu``, its kernel in ``<name>.cuh``, one
    ``<name>/<environment>.cu`` per environment) is read as one text."""
    stem = source[: -len(".cu")]
    own = CSRC / f"{stem}.cuh"
    units = sorted((CSRC / stem).glob("*.cu"))
    text = "".join(p.read_text() for p in [CSRC / source, *([own] if own.exists() else []), *units])
    includes = set(re.findall(r'#include "([^"]+)"', text)) - {f"{stem}.cuh", f"../{stem}.cuh"}
    assert includes == set(HEADERS[source])
    for unit in units:
        assert set(re.findall(r'#include "([^"]+)"', unit.read_text())) == {f"../{stem}.cuh"}
    for header in ("pmsm_drive.cuh", "policy_laws.cuh", "foc_laws.cuh", "fastmath.cuh", "action_ring.cuh"):
        for definition in re.findall(r"^struct (\w+) \{|^__device__ __forceinline__ \w+ (\w+)\(",
                                     (CSRC / header).read_text(), flags=re.M):
            name = next(n for n in definition if n)
            assert not re.search(rf"^struct {name} \{{", text, flags=re.M), (source, name)
    assert not re.search(r"#include <(torch|ATen|c10|pybind11)", text)


@pytest.mark.parametrize("name", ["Pendulum", "CartPole", "MassSpringDamper", "PMSM", "VanDerPol", "FluidTank",
                                  "Acrobot", "InductionMachine", "EESM"])
def test_default_device_is_cuda_and_never_falls_back(name):
    cls = getattr(P, name)
    if torch.cuda.is_available():
        assert cls(batch_size=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(batch_size=2)
    assert cls(batch_size=2, device="cpu").device.type == "cpu"
