"""Batched MuJoCo environments with the same surface as the ODE envs
(counterpart of ``exciting_environments_tpu/wrappers/mujoco.py``).

Wraps a compiled MuJoCo model into the ``reset``/``step``/``vmap_*`` API and
derives min/max normalizations from joint and actuator limits (NaN where the
model gives none — construction fails until the user supplies them).

The port has the host ``cpu`` backend only: MJX is a JAX package, so
``backend="mjx"`` raises.  The state (:class:`MjCpuData`) lives on the
wrapper's device.  A step makes one device-to-host copy of ``qpos, qvel,
act, time`` and the denormalized control, runs ``mujoco.mj_step`` for each
instance under the scratch lock, and makes one host-to-device copy back.
Random resets draw from the keys of
:mod:`~exciting_environments_torch.ops.random`, the JAX package's uniforms
bit for bit.
"""

from __future__ import annotations

import math
import threading
from dataclasses import fields
from typing import Any, Dict

import mujoco
import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import resolve_device
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import MinMaxNormalization

#: MJX (``mujoco.mjx``) is written in JAX; the port has no counterpart
MJX_AVAILABLE = False


@dataclass
class MjCpuData:
    """Simulation state of the ``cpu`` backend: the integrated coordinates
    plus actuator activations and time — everything ``mujoco.mj_step``
    carries across steps (derived quantities are recomputed by the engine
    each step)."""

    qpos: object
    qvel: object
    act: object
    time: object


def dict_to_pytree_dataclass(class_name: str, data: Dict[str, Any]):
    """Synthesize a dataclass type from a dict (field per key); returns the
    instance and the type."""
    namespace = {"__annotations__": {key: type(value) for key, value in data.items()}}
    cls = dataclass(type(class_name, (object,), namespace))
    return cls(**data), cls


# joint-type (mjtJoint) -> qpos/qvel component names and angle flags
QPOS_NAMES_BY_JOINT_TYPE = {
    "0": [  # free joint
        "body_position_x",
        "body_position_y",
        "body_position_z",
        "body_orientation_qw",
        "body_orientation_qx",
        "body_orientation_qy",
        "body_orientation_qz",
    ],
    "1": ["ball_orientation_qw", "ball_orientation_qx", "ball_orientation_qy", "ball_orientation_qz"],
    "2": ["position"],  # slide
    "3": ["angle"],  # hinge
}
QVEL_NAMES_BY_JOINT_TYPE = {
    "0": [
        "body_linear_velocity_x",
        "body_linear_velocity_y",
        "body_linear_velocity_z",
        "body_angular_velocity_x",
        "body_angular_velocity_y",
        "body_angular_velocity_z",
    ],
    "1": ["ball_angular_velocity_x", "ball_angular_velocity_y", "ball_angular_velocity_z"],
    "2": ["linear_velocity"],
    "3": ["angular_velocity"],
}
QPOS_IS_ANGLE_BY_JOINT_TYPE = {"0": [0, 0, 0, 1, 1, 1, 1], "1": [1, 1, 1, 1], "2": [0], "3": [1]}


def _has_nan(normalizations) -> bool:
    return any(bool(np.isnan(np.asarray(v, dtype=np.float64)).any()) for v in structures.leaves(_as_tree(normalizations)))


def _as_tree(obj):
    """Normalization dataclasses (nested) as a tree of their min/max."""
    if structures.is_dataclass(obj):
        return [_as_tree(getattr(obj, f.name)) for f in fields(obj)]
    return obj


class MujucoWrapper:
    """Batched simulation of a MuJoCo model with normalization support.

    Args:
        mujoco_model: a compiled ``mujoco.MjModel``.
        physical_normalizations: dataclass of per-qpos/qvel
            ``MinMaxNormalization``; derived from joint limits if omitted
            (errors on NaN gaps the model cannot fill).
        action_normalization: dataclass of per-actuator normalization;
            derived from actuator ctrl ranges if omitted.
        batch_size: number of parallel simulations.
        tau: simulation step; must equal ``model.opt.timestep``.
        backend: ``"cpu"`` (host ``mujoco.mj_step``) or ``"auto"`` (the
            same); ``"mjx"`` raises, the port has no MJX.
        device: where the state lives (default CUDA; raises without it).
        dtype: floating dtype of the state.
    """

    def __init__(
        self,
        mujoco_model,
        physical_normalizations=None,
        action_normalization=None,
        batch_size: int = 8,
        tau: float = None,
        backend: str = "auto",
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        if backend == "auto":
            backend = "cpu"
        if backend not in ("mjx", "cpu"):
            raise ValueError(f"backend must be 'mjx', 'cpu' or 'auto', got {backend!r}")
        if backend == "mjx":
            raise ImportError(
                "backend='mjx' needs the mujoco-mjx package, which is written in JAX; the PyTorch port "
                "steps the C engine on the host: pass backend='cpu'."
            )
        self.backend = backend
        self.device = resolve_device(device)
        self.dtype = dtype
        self._scratch_data = mujoco.MjData(mujoco_model)
        # the scratch MjData is shared per-wrapper state: steps from several
        # threads must not interleave on it
        self._scratch_lock = threading.Lock()
        if not tau:
            self.tau = mujoco_model.opt.timestep
        else:
            assert tau == mujoco_model.opt.timestep, (
                f"tau ({tau}) must match the MuJoCo model timestep ({mujoco_model.opt.timestep})"
            )
            self.tau = tau

        self.batch_size = batch_size
        self.qpos_dim = mujoco_model.nq
        self.qvel_dim = mujoco_model.nv
        self.action_dim = mujoco_model.nu
        self.sensor_dim = mujoco_model.nsensordata
        self.mujoco_model = mujoco_model

        action_names = [
            mujoco.mj_id2name(mujoco_model, mujoco.mjtObj.mjOBJ_ACTUATOR, i) for i in range(mujoco_model.nu)
        ]

        if not action_normalization:
            action_normalization = self.generate_action_normalization_dataclasses(mujoco_model)
            if _has_nan(action_normalization):
                raise ValueError(
                    "action_normalization must be passed: the MuJoCo model does not provide all "
                    "required actuator ranges. Call generate_action_normalization_dataclasses() to "
                    "get the current dataclass and fill the NaN entries."
                )
        elif _has_nan(action_normalization):
            raise ValueError(
                "NaN values in action_normalization. Call "
                "generate_action_normalization_dataclasses() and fill the NaN entries."
            )

        if not physical_normalizations:
            phys_norm = self.generate_physical_normalization_dataclasses(mujoco_model)
            if _has_nan(phys_norm):
                raise ValueError(
                    "physical_normalizations must be passed: the MuJoCo model does not provide all "
                    "required qpos/qvel ranges. Call generate_physical_normalization_dataclasses() "
                    "to get the current dataclass and fill the NaN entries."
                )
        else:
            if _has_nan(physical_normalizations):
                raise ValueError(
                    "NaN values in physical_normalizations. Call "
                    "generate_physical_normalization_dataclasses() and fill the NaN entries."
                )
            phys_norm = physical_normalizations
            # angle metadata is derived from the model even for user norms
            self.generate_physical_normalization_dataclasses(mujoco_model)

        self.env_properties = self.EnvProperties(
            physical_normalizations=phys_norm,
            action_normalizations=action_normalization,
            static_params=None,
        )

        self.action_description = action_names
        self.obs_description = [f.name for f in fields(phys_norm.qpos)] + [f.name for f in fields(phys_norm.qvel)]

    # ------------------------------------------------------------------
    # normalization synthesis from model metadata
    # ------------------------------------------------------------------

    def generate_physical_normalization_dataclasses(self, model):
        """Derive qpos/qvel normalizations from joint limits; angles without
        limits default to +-pi, everything else unknown becomes NaN."""
        q_pos = {}
        q_vel = {}
        is_angle = []
        for i in range(model.njnt):
            joint = model.joint(i)
            jt = str(joint.type[0])
            qpos_names = [joint.name + "_" + n for n in QPOS_NAMES_BY_JOINT_TYPE[jt]]
            qvel_names = [joint.name + "_" + n for n in QVEL_NAMES_BY_JOINT_TYPE[jt]]
            angle_flags = QPOS_IS_ANGLE_BY_JOINT_TYPE[jt]
            is_angle += angle_flags
            for k, name in enumerate(qpos_names):
                if joint.limited[0] == 0:
                    if angle_flags[k] == 1:
                        q_pos[name] = MinMaxNormalization(min=-math.pi, max=math.pi)
                    else:
                        q_pos[name] = MinMaxNormalization(min=math.nan, max=math.nan)
                else:
                    q_pos[name] = MinMaxNormalization(min=float(joint.range[0]), max=float(joint.range[1]))
            for name in qvel_names:
                q_vel[name] = MinMaxNormalization(min=math.nan, max=math.nan)

        q_pos_dc, _ = dict_to_pytree_dataclass("qpos", q_pos)
        q_vel_dc, _ = dict_to_pytree_dataclass("qvel", q_vel)
        self.qpos_is_angle = is_angle
        return self.PhysicalNormalizations(qpos=q_pos_dc, qvel=q_vel_dc)

    def generate_action_normalization_dataclasses(self, model):
        """Derive actuator normalizations from ctrl ranges (NaN when unlimited)."""
        action_names = [mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_ACTUATOR, i) for i in range(model.nu)]
        ranges = model.actuator_ctrlrange
        limited = model.actuator_ctrllimited
        data = {
            name: (
                MinMaxNormalization(min=math.nan, max=math.nan)
                if limited[i] == 0
                else MinMaxNormalization(min=float(ranges[i, 0]), max=float(ranges[i, 1]))
            )
            for i, name in enumerate(action_names)
        }
        action_normalization, _ = dict_to_pytree_dataclass("Action", data)
        return action_normalization

    @dataclass
    class PhysicalNormalizations:
        qpos: object
        qvel: object

    @dataclass
    class EnvProperties:
        """Constant-per-simulation properties."""

        physical_normalizations: object
        action_normalizations: object
        static_params: object

    # ------------------------------------------------------------------
    # the host engine
    # ------------------------------------------------------------------

    def _make_data(self, batch_shape=()):
        """Fresh default simulation state with leading ``batch_shape``."""
        m = self.mujoco_model
        full = lambda values: torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=self.dtype).to(
            self.device).expand(tuple(batch_shape) + np.shape(values))
        return MjCpuData(qpos=full(m.qpos0), qvel=full(np.zeros(m.nv)), act=full(np.zeros(m.na)),
                         time=full(np.zeros(())))

    def _with_qpos_qvel(self, data, qpos, qvel):
        return MjCpuData(qpos=qpos, qvel=qvel, act=data.act, time=data.time)

    def _cpu_step_host(self, packed):
        """One ``mj_step`` per row of ``packed`` (``(N, nq + nv + na + 1 +
        nu)`` float64: qpos, qvel, act, time, ctrl) on the host; returns the
        stepped ``(N, nq + nv + na + 1)``."""
        m, d = self.mujoco_model, self._scratch_data
        nq, nv, na = m.nq, m.nv, m.na
        out = np.empty((packed.shape[0], nq + nv + na + 1))
        with self._scratch_lock:
            for i, row in enumerate(packed):
                # reset the shared scratch MjData first: mj_step writes solver
                # warm-start state (qacc_warmstart, ...) into it, which would
                # otherwise leak across samples and calls
                mujoco.mj_resetData(m, d)
                d.qpos[:] = row[:nq]
                d.qvel[:] = row[nq:nq + nv]
                d.act[:] = row[nq + nv:nq + nv + na]
                d.time = row[nq + nv + na]
                d.ctrl[:] = row[nq + nv + na + 1:]
                mujoco.mj_step(m, d)
                out[i, :nq], out[i, nq:nq + nv], out[i, nq + nv:nq + nv + na] = d.qpos, d.qvel, d.act
                out[i, -1] = d.time
        return out

    def _cpu_step(self, data, action):
        """:meth:`_cpu_step_host` over any leading batch dims: one copy to
        the host, one back."""
        m = self.mujoco_model
        lead = tuple(data.time.shape)
        n = math.prod(lead)
        cols = [data.qpos.reshape(n, m.nq), data.qvel.reshape(n, m.nv), data.act.reshape(n, m.na),
                data.time.reshape(n, 1), action.reshape(n, m.nu)]
        packed = torch.cat([c.to(torch.float64) for c in cols], dim=1).cpu().numpy()
        out = torch.from_numpy(self._cpu_step_host(packed)).to(self.device, self.dtype)
        qpos, qvel, act, time = torch.split(out, [m.nq, m.nv, m.na, 1], dim=1)
        return MjCpuData(qpos=qpos.reshape(lead + (m.nq,)), qvel=qvel.reshape(lead + (m.nv,)),
                         act=act.reshape(lead + (m.na,)), time=time.reshape(lead))

    # ------------------------------------------------------------------
    # functional API (mirrors CoreEnvironment, elementwise over leading dims)
    # ------------------------------------------------------------------

    def init_state(self, env_properties, rng=None, batch_shape=()):
        """Fresh simulation state; random qpos/qvel when keys are given
        (``batch_shape + (2,)``)."""
        data = self._make_data(batch_shape)
        if rng is not None:
            # independent keys per draw (the reference reuses one subkey)
            pair = prng.split(rng)
            key, subkey = pair[..., 0, :], pair[..., 1, :]
            qpos_norm = prng.uniform(subkey, self.qpos_dim, self.dtype, minval=-1, maxval=1)
            qvel_norm = prng.uniform(key, self.qvel_dim, self.dtype, minval=-1, maxval=1)
            qpos = self.denormalize_components(qpos_norm, env_properties.physical_normalizations.qpos)
            qvel = self.denormalize_components(qvel_norm, env_properties.physical_normalizations.qvel)
            data = self._with_qpos_qvel(data, qpos, qvel)
        return data

    def generate_observation(self, state, env_properties):
        """Normalized (angle-wrapped) qpos followed by normalized qvel."""
        is_angle = torch.as_tensor(self.qpos_is_angle, dtype=torch.bool, device=state.qpos.device)
        qpos = torch.where(is_angle, self.transform_angle(state.qpos), state.qpos)
        qpos_norm = self.normalize_components(qpos, env_properties.physical_normalizations.qpos)
        qvel_norm = self.normalize_components(state.qvel, env_properties.physical_normalizations.qvel)
        return torch.cat([qpos_norm, qvel_norm], dim=-1)

    def transform_angle(self, theta):
        return (theta + math.pi) % (2 * math.pi) - math.pi

    def normalize_components(self, array, normalizations):
        return torch.stack([getattr(normalizations, f.name).normalize(array[..., i])
                            for i, f in enumerate(fields(normalizations))], dim=-1)

    def denormalize_components(self, array, normalizations):
        return torch.stack([getattr(normalizations, f.name).denormalize(array[..., i])
                            for i, f in enumerate(fields(normalizations))], dim=-1)

    def denormalize_action(self, action_norm, env_properties):
        """Denormalize a normalized actuator vector component-wise."""
        return self.denormalize_components(action_norm, env_properties.action_normalizations)

    def reset(self, env_properties, rng=None, initial_qpos_qvel=None, batch_shape=()):
        """Reset to default, random, or a provided flat qpos+qvel vector."""
        if initial_qpos_qvel is not None:
            assert initial_qpos_qvel.shape[-1] == self.qpos_dim + self.qvel_dim
            initial_qpos_qvel = torch.as_tensor(initial_qpos_qvel, dtype=self.dtype).to(self.device)
            data = self._with_qpos_qvel(
                self._make_data(initial_qpos_qvel.shape[:-1]),
                initial_qpos_qvel[..., : self.qpos_dim],
                initial_qpos_qvel[..., self.qpos_dim:],
            )
        else:
            data = self.init_state(env_properties, rng, batch_shape)
        obs = self.generate_observation(data, env_properties)
        return obs, data

    def step(self, mjx_data, action_norm, env_properties):
        """One engine step with a normalized actuator command ``(...,
        action_dim)`` (host ``mj_step``)."""
        assert tuple(action_norm.shape[-1:]) == (self.action_dim,), (
            f"The action needs to be of shape (..., action_dim) with action_dim "
            f"{self.action_dim}, but {tuple(action_norm.shape)} is given"
        )
        action = self.denormalize_action(action_norm, env_properties)
        data = self._cpu_step(mjx_data, action)
        obs = self.generate_observation(data, env_properties)
        return obs, data

    def vmap_step(self, mjx_data, action):
        """One step for all ``batch_size`` simulations."""
        assert tuple(action.shape) == (self.batch_size, self.action_dim), (
            "The action needs to be of shape (batch_size, action_dim) which is "
            f"{(self.batch_size, self.action_dim)}, but {tuple(action.shape)} is given"
        )
        return self.step(mjx_data, action, self.env_properties)

    def vmap_init_state(self, rng=None):
        """Batched :meth:`init_state`: ``rng`` is ``(batch_size, 2)`` keys."""
        return self.init_state(self.env_properties, rng, (self.batch_size,))

    def vmap_reset(self, rng=None, initial_qpos_qvel=None):
        """Batched :meth:`reset`."""
        return self.reset(self.env_properties, rng, initial_qpos_qvel, (self.batch_size,))

    def generate_state_from_observation(self, obs, env_properties, key=None):
        """A fresh state whose qpos/qvel reproduce ``obs`` (up to angle
        wrapping), over any leading dims."""
        qpos_norm = obs[..., : self.qpos_dim]
        qvel_norm = obs[..., self.qpos_dim: self.qpos_dim + self.qvel_dim]
        qpos = self.denormalize_components(qpos_norm, env_properties.physical_normalizations.qpos)
        qvel = self.denormalize_components(qvel_norm, env_properties.physical_normalizations.qvel)
        return self._with_qpos_qvel(self._make_data(obs.shape[:-1]), qpos, qvel)

    def vmap_generate_state_from_observation(self, obs, key=None):
        """Batched :meth:`generate_state_from_observation`."""
        return self.generate_state_from_observation(obs, self.env_properties, key)
