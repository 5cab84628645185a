"""Production fleet loop: chunked fused rollouts with streaming metrics,
dataset sinking and periodic checkpointing (counterpart of
``exciting_environments_tpu/utils/fleet.py``).

A data-generation or excitation deployment needs the loop around the
kernels: pick the execution path for the environment, stream the horizon
in chunks so the host stays ahead of the device, fold per-chunk statistics
into O(1)-state accumulators (one host read per chunk), spill trajectories
to disk through the asynchronous shard writer, and checkpoint the
simulation state so long sweeps resume after the process dies.
:class:`FleetRunner` composes these subsystems:

* execution, by the kernels' scope alone: the loop asks
  :func:`~exciting_environments_torch.ops.kernels.rollout_path` (or, for a
  closed loop, :func:`~exciting_environments_torch.ops.kernels.closed_loop_path`)
  for the route and launches through the environment's own
  ``fused_rollout`` or ``fused_closed_loop``, which picks the PMSM drive
  kernel (``csrc/pmsm_stepper.cu``, ``csrc/pmsm_closed_loop.cu``) or the
  generic one (``csrc/stepper.cu``, ``csrc/closed_loop.cu``), once per
  shard through a
  :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv` (on CPU
  tensors the plain versions); out of scope, ``vmap_rollout`` or
  :func:`~exciting_environments_torch.utils.collect.tile_policy_scan`;
* metrics: :mod:`exciting_environments_torch.parallel.metrics` running
  statistics over the observation channels on the device, plus the last
  chunks' wall times and step counts on the host;
* sink: :class:`exciting_environments_torch.io.ShardWriter` (optional);
* checkpoints: :mod:`exciting_environments_torch.utils.checkpoint`
  (optional), in the JAX package's ``.npz`` layout, so a fleet checkpoint
  written by either package resumes in the other.

No fallback hides a kernel: a closed loop on an environment in a kernel's
scope takes the kernel, and on CUDA a policy outside the compiled families
raises before a launch.

Under a profiler each chunk is the span ``ee.fleet.chunk`` (the chunks in
order of their start times) holding ``ee.fleet.actions`` (:meth:`FleetRunner.run`'s
action source), ``ee.fleet.rollout`` (the enqueue: the entry point's
``ee.rollout.prepare``, ``ee.launch.<library>.<mode>`` and
``ee.rollout.rebuild``), ``ee.fleet.stats``, ``ee.fleet.gate`` (the host's
wait for the device), ``ee.fleet.readout`` and, where they run,
``ee.fleet.sink``, ``ee.fleet.checkpoint`` and ``ee.fleet.hook``; elastic
recovery's snapshots and restores are ``ee.fleet.snapshot``
(:func:`~exciting_environments_torch.utils.profiling.annotate`).
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Callable

import torch

from exciting_environments_torch.parallel.metrics import running_init, running_summary, running_update
from exciting_environments_torch.utils.checkpoint import _unflatten, leaves_with_path
from exciting_environments_torch.utils.profiling import annotate

# Exception types elastic recovery must NOT retry: these are deterministic,
# the replayed chunk would raise the same way (the NaN gate's
# FloatingPointError, out-of-scope/shape/contract ValueErrors and TypeErrors,
# plain Python bugs in user-supplied action sources or metric hooks).
# Transient device/runtime failures surface as RuntimeError (a CUDA error is
# a RuntimeError subclass) or OSError and stay retryable; a sticky CUDA error
# fails again on the replay, and max_retries bounds that.
_NON_RETRYABLE = (
    FloatingPointError,
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AttributeError,
    NotImplementedError,
    AssertionError,
)


def _map_tensors(fn, tree):
    """``tree`` (dataclasses, named tuples, tuples, lists, dicts) with ``fn``
    applied to every tensor leaf; other leaves unchanged."""
    return _unflatten(tree, [fn(leaf) if isinstance(leaf, torch.Tensor) else leaf
                             for _, leaf in leaves_with_path(tree)])


def _select_rollout(env_or_sharded):
    """The rollout path for this environment, as a callable ``(state,
    actions_norm) -> (final_obs, final_state)``, the environment the loop
    reads its batch and observation layout from, and the path's name: one
    of ``"sharded_fused"``, ``"sharded_scan"``, ``"pmsm_fused"``,
    ``"fused"``, ``"scan"`` (probe ahead of time with
    :func:`~exciting_environments_torch.ops.kernels.rollout_path`)."""
    from exciting_environments_torch.ops.kernels import rollout_path
    from exciting_environments_torch.utils.episodes import unwrap_sharded

    env, _ = unwrap_sharded(env_or_sharded)
    path = rollout_path(env_or_sharded)
    if path != "scan":

        def run(state, actions):
            # the PMSM drive kernel or the stepper kernel: one launch, or one per shard
            return env_or_sharded.fused_rollout(state, actions, strict=True)

    else:

        def run(state, actions):
            obs, last = env_or_sharded.vmap_rollout(state, actions, actions.shape[1])
            return obs[:, -1], last

    if env is not env_or_sharded:
        path = "sharded_scan" if path == "scan" else "sharded_fused"
    return run, env, path


def _select_closed_loop(env_or_sharded, policy):
    """The closed-loop path as ``(state, n_steps, policy_params[,
    policy_carry]) -> (final_obs, final_state[, final_carry])`` plus the
    base environment and the path's name: one of ``"sharded_closed_loop"``,
    ``"pmsm_closed_loop_fused"``, ``"closed_loop_fused"``,
    ``"closed_loop_scan"`` (probe ahead of time with
    :func:`~exciting_environments_torch.ops.kernels.closed_loop_path`).

    The policy keeps the tile contract everywhere, ``policy(obs_tuple,
    step[, carry][, params]) -> action component tuple``, so the same policy
    runs in a kernel and, for an environment outside the kernels' scope,
    over ``(B,)`` observation columns of the whole batch in
    :func:`~exciting_environments_torch.utils.collect.tile_policy_scan`.
    An environment in scope always takes the kernel: on CUDA tensors a
    policy outside the compiled families raises there, before a launch; on
    CPU tensors the kernels' plain versions run any callable.
    """
    from exciting_environments_torch.ops.kernels import closed_loop_path
    from exciting_environments_torch.utils.collect import tile_policy_scan
    from exciting_environments_torch.utils.episodes import unwrap_sharded

    env, _ = unwrap_sharded(env_or_sharded)
    path = closed_loop_path(env_or_sharded)
    if path is None:

        def run(state, n_steps, policy_params, policy_carry=None):
            return tile_policy_scan(env, state, n_steps, policy, policy_params, collect_trajectory=False,
                                    policy_carry=policy_carry)

        return run, env, "closed_loop_scan"

    def run(state, n_steps, policy_params, policy_carry=None):
        # one launch of the PMSM or the generic closed-loop kernel, or one per shard
        return env_or_sharded.fused_closed_loop(state, policy, n_steps, policy_params=policy_params,
                                                policy_carry=policy_carry)

    return run, env, path if env is env_or_sharded else "sharded_closed_loop"


class FleetRunner:
    """Chunked fleet data-generation loop.

    Args:
        env: a :class:`CoreEnvironment` or
            :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`.
        writer: optional :class:`~exciting_environments_torch.io.ShardWriter`;
            each chunk's ``(final_obs, actions?)`` record is appended.
        write_actions: also sink each chunk's action slab (large!).
        checkpoint_dir: when set, a self-contained checkpoint (simulation
            state plus the loop's statistics and counters) is written every
            ``checkpoint_every`` chunks; after a process death, a fresh
            runner picks up with :meth:`resume`.
        checkpoint_every: checkpoint period in chunks (0 disables).
        window: how many of the last chunks the throughput readout
            averages over.

    The statistics live on the environment's device (a ``ShardedEnv``'s
    first device) in float32; the last ``window`` chunks' wall times and
    env-step counts (:attr:`time_window`, :attr:`steps_window`) are host
    floats, so the readout adds no device work to a chunk.
    """

    def __init__(
        self,
        env,
        writer=None,
        write_actions: bool = False,
        checkpoint_dir: str = None,
        checkpoint_every: int = 0,
        window: int = 32,
    ):
        self._rollout, self._base_env, self.rollout_path = _select_rollout(env)
        # surface the selection once: the scan is a performance cliff the
        # user should see, not discover from timings
        logging.getLogger(__name__).info(
            "FleetRunner: selected rollout path %r for %s",
            self.rollout_path, type(self._base_env).__name__,
        )
        self.env = env
        self.writer = writer
        self.write_actions = write_actions
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self._device = torch.device(self._base_env.device)
        self.obs_stats = running_init(
            shape=(len(self._base_env.obs_description),), dtype=torch.float32, device=self._device
        )
        self.time_window = deque(maxlen=window)
        # per-chunk env-step counts over the SAME window, so the throughput
        # readout stays correct when chunk sizes vary across the runner's
        # lifetime (mixed run()/run_policy() chunk_steps, resume())
        self.steps_window = deque(maxlen=window)
        self.chunks_run = 0
        self.env_steps = 0

    def run(
        self,
        state,
        action_source: Callable,
        n_chunks: int,
        chunk_steps: int,
        metric_hook: Callable = None,
        max_retries: int = 0,
    ):
        """Run ``n_chunks`` rollout chunks of ``chunk_steps`` steps each.

        Args:
            state: batched initial state.
            action_source: ``action_source(chunk_index) -> (B, chunk_steps,
                action_dim)`` normalized actions (e.g. a closure over
                :mod:`ops.signals` generators).
            metric_hook: optional ``hook(chunk_index, final_obs, state)``
                called after each chunk (e.g. to feed external telemetry).
            max_retries: elastic recovery: on a transient device/runtime
                failure, roll the loop back to an in-memory host snapshot of
                the last completed chunk (state AND statistics) and re-run,
                up to this many consecutive retries (see :meth:`_drive`).

        Returns:
            the final state.
        """

        def chunk(k, state):
            with annotate("ee.fleet.actions"):
                actions = action_source(k)
            t0 = time.perf_counter()  # the action source's work stays untimed
            with annotate("ee.fleet.rollout"):
                obs, state = self._rollout(state, actions)
            record = {"final_obs": obs}
            if self.write_actions:
                record["actions"] = actions
            return obs, state, record, t0

        return self._drive(state, n_chunks, chunk_steps, chunk, metric_hook, max_retries)

    def run_policy(
        self,
        state,
        policy_tile: Callable,
        n_chunks: int,
        chunk_steps: int,
        policy_params=None,
        metric_hook: Callable = None,
        max_retries: int = 0,
        policy_carry=None,
    ):
        """Closed-loop variant of :meth:`run`: instead of an external action
        source, ``policy_tile(obs, step[, params])`` (the tile contract of
        :meth:`CoreEnvironment.fused_closed_loop`) drives each chunk, in the
        closed-loop kernel where the environment is in its scope (on CUDA
        an ``AffinePolicy``, the actor or a tile of ``utils/foc.py``), over
        ``(B,)`` observation columns otherwise.  The selected path is cached
        per policy object and surfaced via :attr:`closed_loop_path`; all
        chunk bookkeeping (running statistics, NaN gate, sink, checkpoints,
        ``max_retries`` elastic recovery) matches :meth:`run`.

        ``policy_carry`` (tuple of ``(B,)`` float leaves) runs a STATEFUL
        law, ``policy(obs, step, carry[, params]) -> (action, carry)``, with
        the carry threaded BETWEEN chunks like the simulation state: it
        snapshots/rolls back with elastic recovery and lands in checkpoints
        (resume with ``like_state=(state_template, carry_template)`` and pass
        the returned carry back in).  Returns ``(final_state, final_carry)``
        instead of the plain final state.
        """
        cached = getattr(self, "_closed_loop", None)
        if cached is None or cached[0] is not policy_tile:
            run_fn, _, name = _select_closed_loop(self.env, policy_tile)
            self.closed_loop_path = name
            logging.getLogger(__name__).info(
                "FleetRunner: selected closed-loop path %r for %s",
                name, type(self._base_env).__name__,
            )
            self._closed_loop = cached = (policy_tile, run_fn)
        run_fn = cached[1]

        if policy_carry is None:

            def chunk(k, state):
                t0 = time.perf_counter()
                with annotate("ee.fleet.rollout"):
                    obs, state = run_fn(state, chunk_steps, policy_params)
                return obs, state, {"final_obs": obs}, t0

            return self._drive(state, n_chunks, chunk_steps, chunk, metric_hook, max_retries)

        def chunk(k, state_pc):
            st, pc = state_pc
            t0 = time.perf_counter()
            with annotate("ee.fleet.rollout"):
                obs, st, pc = run_fn(st, chunk_steps, policy_params, tuple(pc))
            return obs, (st, pc), {"final_obs": obs}, t0

        return self._drive(
            (state, tuple(policy_carry)), n_chunks, chunk_steps, chunk,
            metric_hook, max_retries,
        )

    # -- elastic recovery ----------------------------------------------------

    def _snapshot(self, state):
        """Host copy of everything a rollback must restore: the simulation
        state plus the loop's running statistics, throughput windows and
        counters (so a replayed chunk is not double-counted)."""
        to_host = lambda tree: _map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)
        with annotate("ee.fleet.snapshot"):
            return (
                to_host(state), to_host(self.obs_stats), self.time_window.copy(),
                self.steps_window.copy(), self.chunks_run, self.env_steps,
            )

    def _restore(self, snapshot):
        """Put a snapshot back on the device it came from (the environment's
        device, a ``ShardedEnv``'s first device); returns the state to resume
        from."""
        to_dev = lambda tree: _map_tensors(lambda t: t.to(self._device), tree)
        host_state, obs_stats, time_window, steps_window, chunks_run, env_steps = snapshot
        with annotate("ee.fleet.snapshot"):
            self.obs_stats = to_dev(obs_stats)
            self.time_window = time_window.copy()
            self.steps_window = steps_window.copy()
            self.chunks_run = chunks_run
            self.env_steps = env_steps
            return self._place(to_dev(host_state))

    def _place(self, state):
        """Put a host-restored state back on its execution layout: on a
        ``ShardedEnv``, its first device, where it keeps whole trees and
        splits them at each call."""
        from exciting_environments_torch.utils.episodes import unwrap_sharded

        return unwrap_sharded(self.env)[1](state)

    # -- checkpoint / resume (process-death recovery) --------------------------

    def _ckpt_payload(self, state):
        """Self-contained checkpoint tree: the simulation state plus the loop
        bookkeeping a resumed runner must carry on (the counters as 0-d
        int64 arrays, as the JAX package stores them)."""
        return {
            "state": state,
            "obs_stats": self.obs_stats,
            "chunks_run": torch.tensor(self.chunks_run, dtype=torch.int64),
            "env_steps": torch.tensor(self.env_steps, dtype=torch.int64),
        }

    @staticmethod
    def latest_checkpoint(checkpoint_dir: str):
        """Path of the newest ``fleet_*`` checkpoint in ``checkpoint_dir``
        (an ``.npz`` file, or a JAX package orbax directory, which the port
        cannot read), or ``None`` when none exists."""
        best, best_n = None, -1
        for name in os.listdir(checkpoint_dir) if os.path.isdir(checkpoint_dir) else ():
            stem = name[:-4] if name.endswith(".npz") else name
            if not stem.startswith("fleet_"):
                continue
            try:
                n = int(stem.split("_", 1)[1])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(checkpoint_dir, name), n
        return best

    def resume(self, like_state, path: str = None):
        """Pick up after a process death from an on-disk fleet checkpoint
        (written by this package or the JAX package).

        Restores the loop's statistics and counters into this runner and
        returns ``(state, chunks_done)``.  The caller continues with
        :meth:`run`/:meth:`run_policy` for the *remaining* chunks; with a
        chunk-indexed action source, shift it by ``chunks_done``
        (``lambda k: source(k + chunks_done)``) so the excitation sequence
        continues where the dead process stopped.

        Args:
            like_state: a state with the target structure (e.g. from
                ``env.vmap_reset()``); the restored leaves land on its
                devices.
            path: checkpoint to restore; default: the newest ``fleet_*``
                checkpoint in this runner's ``checkpoint_dir``.
        """
        from exciting_environments_torch.utils.checkpoint import load_state

        if path is None:
            if not self.checkpoint_dir:
                raise ValueError("resume() needs a path or a checkpoint_dir")
            path = self.latest_checkpoint(self.checkpoint_dir)
            if path is None:
                raise FileNotFoundError(
                    f"no fleet_* checkpoint in {self.checkpoint_dir!r}"
                )
        payload = load_state(self._ckpt_payload(like_state), path)
        self.obs_stats = payload["obs_stats"]
        self.chunks_run = int(payload["chunks_run"])
        self.env_steps = int(payload["env_steps"])
        return self._place(payload["state"]), self.chunks_run

    def _drive(self, state, n_chunks, chunk_steps, chunk_fn, metric_hook, max_retries):
        """The chunk loop shared by :meth:`run` and :meth:`run_policy`.

        With ``max_retries > 0`` the loop keeps a host snapshot of the last
        completed chunk and, when a chunk raises a transient device/runtime
        error (a ``RuntimeError`` such as a CUDA error, an ``OSError``),
        rolls state *and* bookkeeping back and re-runs the chunk, up to
        ``max_retries`` consecutive times.  Deterministic exceptions
        (``_NON_RETRYABLE``: the NaN gate's ``FloatingPointError``,
        scope/shape/contract ``ValueError``/``TypeError``, plain Python bugs
        in user hooks) are never retried: the replay would raise the same
        way.  Snapshots cost one device->host copy of the state per chunk,
        so leave retries at 0 for latency-critical sweeps.  The post-chunk
        snapshot runs inside the retry scope: an asynchronous CUDA error
        surfaces at the next synchronizing call, which may be the
        snapshot's own copy rather than the statistics fence.  If a failure
        lands after the shard writer appended, the replayed chunk may
        duplicate one record name.

        ``chunk_fn(k, state) -> (obs, state, record, t0)`` returns its own
        timing origin so host-side work (e.g. an ``action_source`` building
        a slab) stays out of the throughput readout.
        """
        snapshot = self._snapshot(state) if max_retries > 0 else None
        k = 0
        retries = 0
        while k < n_chunks:
            try:
                with annotate("ee.fleet.chunk"):
                    obs, new_state, record, t0 = chunk_fn(k, state)
                    self._after_chunk(k, obs, new_state, chunk_steps, t0, record, metric_hook)
                new_snapshot = self._snapshot(new_state) if snapshot is not None else None
            except _NON_RETRYABLE:
                # deterministic: a replay would raise identically
                raise
            except Exception as e:
                if snapshot is None or retries >= max_retries:
                    raise
                retries += 1
                logging.getLogger(__name__).warning(
                    "fleet chunk %d failed (%r); retry %d/%d from the last "
                    "completed chunk", k, e, retries, max_retries,
                )
                state = self._restore(snapshot)
                continue
            retries = 0
            state = new_state
            snapshot = new_snapshot
            k += 1
        return state

    def _after_chunk(self, k, obs, state, chunk_steps, t0, record, metric_hook):
        # fence: fold the chunk's observations into the running statistics and
        # read back one flag, the one host sync per chunk.  The launches are
        # asynchronous, so the chunk's wall time is read after it.
        with annotate("ee.fleet.stats"):
            self.obs_stats = running_update(self.obs_stats, obs, axis=(0,))
        with annotate("ee.fleet.gate"):
            finite = bool(torch.isfinite(self.obs_stats.mean).all())
        if not finite:
            raise FloatingPointError(
                f"fleet chunk {k}: non-finite observation statistics "
                "(utils.profiling.debug_nans localizes them)"
            )
        with annotate("ee.fleet.readout"):
            self.time_window.append(time.perf_counter() - t0)
            chunk_env_steps = self._base_env.batch_size * chunk_steps
            self.steps_window.append(chunk_env_steps)
            self.chunks_run += 1
            self.env_steps += chunk_env_steps

        if self.writer is not None:
            with annotate("ee.fleet.sink"):
                self.writer.append(record, name=f"chunk_{self.chunks_run:06d}")
        if (
            self.checkpoint_dir
            and self.checkpoint_every
            and (k + 1) % self.checkpoint_every == 0
        ):
            from exciting_environments_torch.utils.checkpoint import save_state

            with annotate("ee.fleet.checkpoint"):
                save_state(
                    self._ckpt_payload(state),
                    os.path.join(self.checkpoint_dir, f"fleet_{self.chunks_run:06d}"),
                )
        if metric_hook is not None:
            with annotate("ee.fleet.hook"):
                metric_hook(k, obs, state)

    def summary(self) -> dict:
        """Loop readout: per-channel observation statistics plus throughput."""
        s = running_summary(self.obs_stats)
        mean = lambda window: sum(window) / max(len(window), 1)
        mean_chunk_seconds = mean(self.time_window)
        # steps-per-chunk from the same recent window as the wall time: the
        # lifetime average is wrong whenever chunk sizes varied
        steps_per_chunk = mean(self.steps_window)
        return {
            "chunks": self.chunks_run,
            "env_steps": self.env_steps,
            "obs_mean": s["mean"],
            "obs_std": s["std"],
            "obs_min": s["min"],
            "obs_max": s["max"],
            "mean_chunk_seconds": mean_chunk_seconds,
            "env_steps_per_sec": (
                steps_per_chunk / mean_chunk_seconds if mean_chunk_seconds > 0 else float("nan")
            ),
        }
