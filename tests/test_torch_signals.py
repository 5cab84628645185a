"""The port's excitation signals (``ops/signals.py``) against the JAX
package's, from the same threefry keys, in both widths: float64 with the
conftest's ``jax_enable_x64`` and float32 inside ``jax.enable_x64(False)``
(the JAX package draws in the default dtypes, whose bits differ).

Tolerances: ``white_uniform`` and ``aprbs`` (levels, hold durations and
their segment search) bit for bit.  ``chirp`` and ``multisine`` evaluate
``sin`` of angles up to ``2 pi f t``: they are held within 4 ulps of the
largest angle (``4 * eps * max_angle``, summed over the harmonics for the
multisine); measured here 2 ulps (float32 chirp) and, for the multisine,
1.2e-14 (float64) and 7.5e-6 (float32), where XLA's compiled ``linspace``
rounds some frequencies one ulp away from its formula and the sines differ
by an ulp between XLA and PyTorch.  The property checks are those of
tests/test_signals_and_collect.py.
"""

import math

import jax
import numpy as np
import pytest
import torch

from exciting_environments_torch.ops import signals as S
from exciting_environments_tpu.ops import signals as JS

WIDTHS = [(True, torch.float64), (False, torch.float32)]
IDS = ["float64", "float32"]


def _key(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _eps(dtype):
    return float(torch.finfo(dtype).eps)


@pytest.mark.parametrize("hold", [(1, 2), (10, 100), (64, 80)], ids=["1-2", "10-100", "hold_min=T"])
@pytest.mark.parametrize("width", WIDTHS, ids=IDS)
def test_aprbs_matches_jax_bit_for_bit(hold, width):
    x64, dtype = width
    jk, tk = _key(3)
    with jax.enable_x64(x64):
        want = np.asarray(JS.aprbs(jk, 8, 64, 3, hold_min=hold[0], hold_max=hold[1], minval=-0.4, maxval=0.7))
    got = S.aprbs(tk, 8, 64, 3, hold_min=hold[0], hold_max=hold[1], minval=-0.4, maxval=0.7, dtype=dtype)
    assert got.dtype == dtype and got.shape == (8, 64, 3) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", WIDTHS, ids=IDS)
def test_white_uniform_matches_jax_bit_for_bit(width):
    x64, dtype = width
    jk, tk = _key(2)
    with jax.enable_x64(x64):
        want = np.asarray(JS.white_uniform(jk, 4, 16, 2, minval=-0.3, maxval=0.9))
    np.testing.assert_array_equal(S.white_uniform(tk, 4, 16, 2, minval=-0.3, maxval=0.9, dtype=dtype).numpy(), want)


@pytest.mark.parametrize("width", WIDTHS, ids=IDS)
def test_chirp_and_multisine_match_jax(width):
    x64, dtype = width
    jk, tk = _key(1)
    with jax.enable_x64(x64):
        jc = np.asarray(JS.chirp(3, 256, 1, tau=1e-3, f0=1.0, f1=50.0, amplitude=0.7))
        jm = np.asarray(JS.multisine(jk, 4, 512, 2, tau=1e-3, f_min=1.0, f_max=40.0))
    pc = S.chirp(3, 256, 1, tau=1e-3, f0=1.0, f1=50.0, amplitude=0.7, device="cpu", dtype=dtype)
    pm = S.multisine(tk, 4, 512, 2, tau=1e-3, f_min=1.0, f_max=40.0, dtype=dtype)
    assert pc.dtype == pm.dtype == dtype
    t1 = 256 * 1e-3
    chirp_angle = 2 * math.pi * (1.0 * t1 + 0.5 * 49.0 * t1)
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=4 * _eps(dtype) * chirp_angle)
    sine_angle = 2 * math.pi * 40.0 * 512 * 1e-3 + 2 * math.pi
    np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=4 * _eps(dtype) * sine_angle * 16)


def test_aprbs_properties():
    _, tk = _key(0)
    a = S.aprbs(tk, 4, 500, 2, hold_min=10, hold_max=50, dtype=torch.float64).numpy()
    assert a.shape == (4, 500, 2)
    assert a.min() >= -1 and a.max() <= 1
    # piecewise constant: many consecutive-equal samples, but not all equal
    diffs = np.abs(np.diff(a, axis=1))
    assert 0.9 < float((diffs < 1e-12).mean()) < 1.0
    n_switches = int((diffs[0, :, 0] > 1e-12).sum())
    assert 500 // 50 <= n_switches <= 500 // 10 + 1
    # channels and batch entries differ
    assert not np.allclose(a[0], a[1])
    assert not np.allclose(a[0, :, 0], a[0, :, 1])


def test_chirp_multisine_and_white_properties():
    c = S.chirp(3, 256, 1, tau=1e-3, f0=1.0, f1=50.0, amplitude=0.7, device="cpu", dtype=torch.float64)
    assert c.shape == (3, 256, 1) and float(c.abs().max()) <= 0.7 + 1e-6
    _, tk = _key(1)
    m = S.multisine(tk, 2, 256, 2, tau=1e-3, f_min=1.0, f_max=40.0, dtype=torch.float64)
    assert m.shape == (2, 256, 2)
    np.testing.assert_allclose(float(m.abs().max()), 1.0, atol=1e-5)
    w = S.white_uniform(tk, 2, 16, 1)
    assert w.shape == (2, 16, 1) and w.dtype == torch.float32
    tm = S.to_time_major(m)
    assert tm.shape == (256, 2, 2) and tm.is_contiguous() and torch.equal(tm[5, 1], m[1, 5])


def test_signals_take_the_device_of_their_key_or_cuda():
    if torch.cuda.is_available():
        assert S.chirp(1, 4, 1, 1e-3, 1.0, 2.0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            S.chirp(1, 4, 1, 1e-3, 1.0, 2.0)
    _, tk = _key(0)
    assert S.aprbs(tk, 2, 8, 1).device == tk.device
