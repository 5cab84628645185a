"""Driver ``train_policy_step``: one iteration of ``utils/train.py::train_policy``'s
loop a call, over a PMSM fleet in the closed-loop kernel's scope: the
optimizer's ``zero_grad``, ``fused_closed_loop`` with the gains as
``policy_params`` and the integrators' carry (a save every step: one launch of
``csrc/pmsm_closed_loop.cu``), the loss, ``backward()`` (one launch of
``csrc/pmsm_closed_loop_adjoint.cu``), Adam's step, and a host read of the
loss, which completes the call.  The configuration's ``train`` block gives
Adam's ``lr``, the loss (a loss factory of ``utils/train.py``, by name) and
a job's ``iterations``; the traffic's
``policy`` holds the starting gains.  The gains and the optimizer's state
carry across calls; every ``iterations``-th call starts a new job from the
starting gains with a fresh optimizer.  The drives' starting states and
current references are drawn from the seed at set-up and start every call;
the integrators start at zero.

What is compared is each job's first iteration, at the starting gains: the
gains' first step makes most drives' loops unstable (PERF.md, section 6),
where the gradient of a 256-step rollout is chaotic, so that float32 and
float64 give different gradients, the reference's own as much as the
program's.  A checked call keeps its job's first iteration: the gains it
ran with, its loss, its gradient and the step the optimizer took, copied
into buffers made before the window opens.  Reference:
``reference/<config>.py``'s ``loss_and_grad`` at those gains.  Readings:
``loss_gap``, the loss's distance from the reference's over the
reference's (NaN where any call of the run gave a non-finite loss, that is
a non-finite drive); ``grad_gap``, the largest distance over the 42 gains
over the reference gradient's largest magnitude; ``step_gap``, the step's
largest distance from Adam's first step ``-lr * g / (|g| + eps)`` of the
call's gradient ``g``, over ``lr``: a step that is not taken reads 1, one
uphill 2."""

from __future__ import annotations

import math

import torch

from portbench.harness import CHECKED_CALLS, HERE, load_module, make_env, start_state, sync
from portbench.traffic import generator

#: ``torch.optim.Adam``'s default ``eps``
ADAM_EPS = 1e-8


class Driver:
    def __init__(self, cell, seed: int, device):
        import exciting_environments_torch as ex
        from exciting_environments_torch.utils import train as train_module

        mix, train = cell.traffic, cell.config["train"]
        self.cell, self.device = cell, device
        self.ref = load_module(HERE / "reference" / f"{cell.config['reference']}.py")
        self.env = make_env(ex, cell, device)
        gen = generator.stream(seed, "inputs", device)
        self.start = generator.fields(gen, mix["initial"], cell.batch, cell.dtype)
        self.refs = generator.fields(gen, mix["references"], cell.batch, cell.dtype)
        self.policy = ex.AffinePolicy(mix["policy"]["K"], Ki=mix["policy"]["Ki"])
        self.state = start_state(self.env, self.start, self.refs)
        self.carry = tuple(torch.zeros(cell.batch, dtype=cell.dtype, device=device) for _ in range(2))
        self.loss_fn = getattr(train_module, train["loss"])(self.env)
        self.job_length, self.lr = int(train["iterations"]), float(train["lr"])
        self.start_gains = self.policy.flat_params().to(device=device, dtype=cell.dtype)
        self.gains = self.start_gains.clone().requires_grad_(True)
        self.before = torch.empty_like(self.start_gains)  # the gains a call ran with
        self.opt = None
        self.steps_per_call = cell.batch * cell.steps
        self.index = self.warmed = 0
        self.job, self.jobs = [], []  # this job's losses; each finished job's (first, last)
        self.finite = True  # every call's loss so far
        # this job's first iteration: the gains it ran with, its gradient and step; its loss
        self.job_first, self.job_first_loss = self._buffers(), None
        self.samples, self.slots, self.first = {}, [], None

    def shapes(self) -> dict:
        n_gains = self.start_gains.numel()
        return {"batch": self.cell.batch, "steps": self.cell.steps, "saves": self.cell.steps,
                "itemsize": torch.tensor([], dtype=self.cell.dtype).element_size(), "per_drive_params": 0,
                "references": len(self.refs),
                # every gain is nonzero from the first step on
                "policy": {"n_carry": 2, "clip": 0, "n_params": n_gains, "nonzero_gains": [10, 10],
                           "nonzero_integral_gains": [10, 10]},
                # the loss reads the saved currents, and through the rebuilt
                # observation the saved torque and buffers; nothing of the finals
                "cotangent_planes": 5, "final_cotangents": 0}

    def describe(self) -> str:
        runs = {}
        for job in self.jobs:
            runs[job] = runs.get(job, 0) + 1
        done = ", ".join(f"{first!r} -> {last!r} ({n} jobs)" for (first, last), n in runs.items()) or "none yet"
        below = all(last < first for first, last in self.jobs)
        return (f"jobs of {self.job_length} iterations of Adam at lr {self.lr}; finished jobs' first and last losses: "
                f"{done}; every finished job ended below its first loss: {below}; every call's loss finite: "
                f"{self.finite}")

    def _buffers(self):
        return tuple(torch.empty_like(self.start_gains) for _ in range(3))

    def _call(self) -> float:
        first = self.index % self.job_length == 0
        if first:
            with torch.no_grad():
                self.gains.copy_(self.start_gains)
            self.opt = torch.optim.Adam([self.gains], lr=self.lr)
            self.job = []
        self.opt.zero_grad()
        obs, acts, *_ = self.env.fused_closed_loop(self.state, self.policy, self.cell.steps, obs_stride=1,
                                                   policy_params=self.gains, policy_carry=self.carry)
        loss = self.loss_fn(obs, acts)
        loss.backward()
        self.before.copy_(self.gains.detach())
        self.opt.step()
        value = float(loss.detach())
        self.finite = self.finite and math.isfinite(value)
        if first:
            gains, grad, step = self.job_first
            gains.copy_(self.before)
            grad.copy_(self.gains.grad)
            torch.sub(self.gains.detach(), self.before, out=step)
            self.job_first_loss = value
        self.job.append(value)
        if len(self.job) == self.job_length:
            self.jobs.append((self.job[0], self.job[-1]))
        self.index += 1
        return value

    def _keep(self, slot):
        """The first iteration of the job of the call that completed last,
        copied into the buffers of ``slot`` (new ones without a slot)."""
        buffers = tuple(b.clone() for b in self.job_first) if slot is None else self.slots[slot]
        if slot is not None:
            for dst, src in zip(buffers, self.job_first):
                dst.copy_(src)
        gains, grad, step = buffers
        return self.index - 1, gains, self.job_first_loss, grad, step

    def warmup(self, n: int):
        for _ in range(n):
            self._call()
            if self.first is None:
                self.first = self._keep(None)
                self.slots = [self._buffers() for _ in range(CHECKED_CALLS)]
        sync(self.device)
        self.warmed += n

    def run_window(self, window):
        ended = False
        while not ended:
            self._call()
            ended = window.complete()
            slot = window.keep()
            if slot is not None:
                self.samples[slot] = self._keep(slot)
            if not ended:
                window.begin()

    def release(self):
        self.opt = None

    def compare(self, dtype: torch.dtype = torch.float64, control: bool = False) -> list:
        """Per checked call, ``{number: reading}`` of its job's first
        iteration: the program's loss, gradient and step (with ``control``,
        the reference's loss and gradient in bfloat16 and Adam's first step
        taken from them in bfloat16 arithmetic in their place) against the
        reference's in ``dtype`` at the gains it ran with."""
        print(f"[portbench] {self.describe()}", flush=True)
        cases = {c[0]: c for c in [self.first, *self.samples.values()]}
        phys = self.state.physical_state
        start = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
        refs = (self.refs["i_d"], self.refs["i_q"])
        readings = []
        for k in sorted(cases):
            _, gains, value, grad, step = cases[k]
            run = lambda dt: self.ref.loss_and_grad(start, phys.omega_el, refs, self.carry, gains,
                                                    self.cell.steps, self.env.tau, dt)
            t_loss, t_grad = run(dtype)
            if control:
                value, grad = run(torch.bfloat16)
                low, g = gains.to(torch.bfloat16), grad.to(torch.bfloat16)
                step = (low - self.lr * g / (g.abs() + ADAM_EPS)).double() - low.double()
            g = grad.double()
            first_step = -self.lr * g / (g.abs() + ADAM_EPS)
            loss_gap = abs(float(value) - float(t_loss)) / abs(float(t_loss))
            grad_gap = float((g - t_grad).abs().max()) / float(t_grad.abs().max())
            step_gap = float((step.double() - first_step).abs().max()) / self.lr
            readings.append({"loss_gap": loss_gap if math.isfinite(float(value)) and self.finite else math.nan,
                             "grad_gap": grad_gap, "step_gap": step_gap})
        return readings
