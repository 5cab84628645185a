"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged;
half of the batch left out (for the fleets, the running statistics' mean
taken over the rest); an answer altered where it is produced; a call that
does not launch its kernel once.  (No cell spans chips, so none leaves out
an exchange between them.)  The runs skip the harness's look for a card and
run on the CPU at a small size; the tests marked ``gpu`` run on the card,
where a call routed around its kernel gives right answers and only the
launch count catches it."""

import pytest
import torch

import exciting_environments_torch as ex
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.kernels import pmsm_closed_loop, pmsm_stepper
from exciting_environments_torch.utils import fleet
from portbench import harness
from small import SMALL

SEED = 2**31 + 77


def run(cell_name):
    return harness.run_cell(cell_name, SEED, 0.3, False, "cpu", overrides={**SMALL[cell_name], "dtype": "float32"},
                            log=lambda line: None)


def unchanged(monkeypatch, cell_name):
    if cell_name.startswith("pendulum"):
        monkeypatch.setattr(ex.Pendulum, "fused_rollout",
                            lambda self, state, actions, **kw: (self.generate_observation(state, self.env_properties),
                                                                state))
    elif "pi-fleet" in cell_name:
        def closed_loop(env, state, policy, n_steps, policy_carry=None, **kw):
            return env.generate_observation(state, env.env_properties), state, tuple(policy_carry)
        monkeypatch.setattr(pmsm_closed_loop, "pmsm_fused_closed_loop", closed_loop)
    else:
        original = pmsm_stepper.pmsm_rollout

        def rollout(env, actions, state0, omega, **kw):
            final, u_last, traj = original(env, actions, state0, omega, **kw)
            traj = (state0[0].expand_as(traj[0]), state0[1].expand_as(traj[1])) + tuple(traj[2:])
            return (state0[0], state0[1]) + tuple(final[2:]), u_last, traj
        monkeypatch.setattr(pmsm_stepper, "pmsm_rollout", rollout)


def half_batch(monkeypatch, cell_name):
    if "collect" in cell_name:
        original = pmsm_stepper.pmsm_rollout

        def rollout(env, actions, state0, omega, **kw):
            final, u_last, traj = original(env, actions, state0, omega, **kw)
            half = state0[0].shape[0] // 2
            return final, u_last, tuple(t if t is None else torch.cat([t[:, :half], torch.zeros_like(t[:, half:])], 1)
                                        for t in traj)
        monkeypatch.setattr(pmsm_stepper, "pmsm_rollout", rollout)
    else:
        original = fleet.running_update
        monkeypatch.setattr(fleet, "running_update",
                            lambda stats, values, axis=None: original(stats, values[: values.shape[0] // 2], axis))


def altered(monkeypatch, cell_name):
    bump = lambda leaf: torch.cat([leaf[:3], 1.5 * leaf[3:4] + 1.0, leaf[4:]])
    if cell_name.startswith("pendulum"):
        original = ex.Pendulum.fused_rollout

        def rollout(self, state, actions, **kw):
            obs, final = original(self, state, actions, **kw)
            final = structures.replace(final, physical_state=structures.replace(
                final.physical_state, omega=bump(final.physical_state.omega)))
            return self.generate_observation(final, self.env_properties), final
        monkeypatch.setattr(ex.Pendulum, "fused_rollout", rollout)
    elif "pi-fleet" in cell_name:
        original = pmsm_closed_loop.pmsm_fused_closed_loop

        def closed_loop(env, state, policy, n_steps, **kw):
            obs, final, carry = original(env, state, policy, n_steps, **kw)
            final = structures.replace(final, physical_state=structures.replace(
                final.physical_state, i_d=bump(final.physical_state.i_d)))
            return env.generate_observation(final, env.env_properties), final, carry
        monkeypatch.setattr(pmsm_closed_loop, "pmsm_fused_closed_loop", closed_loop)
    else:
        original = pmsm_stepper.pmsm_rollout

        def rollout(env, actions, state0, omega, **kw):
            final, u_last, traj = original(env, actions, state0, omega, **kw)
            return final, u_last, (bump(traj[0].T).T,) + tuple(traj[1:])
        monkeypatch.setattr(pmsm_stepper, "pmsm_rollout", rollout)


def extra_launch(monkeypatch, cell_name):
    """Each call counts one launch of the cell's kernel more than it makes
    (on the CPU, where the program's plain path launches none, one)."""
    counter = next(iter(harness.launch_counters(harness.Cell(cell_name).kernels).values()))
    mode = next(iter(counter.launches))
    original = harness.Window.complete

    def complete(self, *args, **kwargs):
        counter.launches[mode] += 1
        return original(self, *args, **kwargs)
    monkeypatch.setattr(harness.Window, "complete", complete)


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_a_sound_run_is_correct(cell_name):
    result = run(cell_name)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert result["checks"]["launch_gap"] == {"value": 0.0, "limit": 0.0}


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_a_traced_run_that_finds_no_kernel_gives_no_result(cell_name):
    with pytest.raises(harness.MissingReading):
        harness.run_cell(cell_name, SEED, 0.3, True, "cpu", overrides={**SMALL[cell_name], "dtype": "float32"},
                         log=lambda line: None)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered, extra_launch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell_name, fault):
    fault(monkeypatch, cell_name)
    result = run(cell_name)
    assert result["correct"] is False and result["failed"] > 0, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("routed", [False, True], ids=["through_the_kernel", "around_the_kernel"])
def test_the_launch_count_on_the_card(card, monkeypatch, routed):
    name = "pendulum-fleet-t4096"
    if routed:
        from exciting_environments_torch.ops.kernels import stepper

        monkeypatch.setattr(stepper, "supports_fused_rollout", lambda env: False)
    result = harness.run_cell(name, SEED, 0.3, False, card, overrides={**SMALL[name], "dtype": "float32"},
                              log=lambda line: None)
    answers = {k: v for k, v in result["checks"].items() if k != "launch_gap"}
    assert all(v["value"] <= v["limit"] for v in answers.values()), result["checks"]
    assert (result["checks"]["launch_gap"]["value"] > 0) == routed and result["correct"] is not routed
