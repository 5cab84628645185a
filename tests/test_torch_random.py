"""The port's threefry random numbers (``ops/random.py``) against
``jax.random`` (threefry2x32, partitionable), from the same key words.

Tolerances: keys (``PRNGKey``, ``split``, ``fold_in``) and the cipher's
words are compared bit for bit, and so is ``uniform`` (bit cast, then the
fused multiply-add that XLA computes on the CPU), over bounds whose span is
a power of two and over bounds whose product rounds, and ``choice`` (with
and without ``p``, over 1, 3 and 1,000 values, in both widths).  ``normal`` and
``exponential`` go through ``erfinv`` and ``log1p``, whose implementations
differ between XLA and PyTorch by a few ulps: ``normal`` is held within
1e-5 abs in float32 and 5e-14 abs in float64 (measured here: 5.0e-6 and
2.1e-14 over these draws, the largest in the tails), ``exponential`` within
1e-6 abs in float32 and 5e-14 in float64 (measured 2.4e-7 and 1.4e-14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from exciting_environments_torch.ops import random as R

SEEDS = [0, 1, 42, 2**33 + 5]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
NORMAL_ATOL = {torch.float32: 1e-5, torch.float64: 5e-14}
EXP_ATOL = {torch.float32: 1e-6, torch.float64: 5e-14}


def _words(keys):
    return np.asarray(keys).astype(np.int64)


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.as_tensor(_words(jk))


def test_cipher_matches_jax_threefry_words():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel()))
    got0, got1 = R.threefry2x32(int(k[0]), int(k[1]), torch.as_tensor(x[0].astype(np.int64)),
                                torch.as_tensor(x[1].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([got0.numpy(), got1.numpy()]), _words(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(R.split(tk, num).numpy(), _words(jax.random.split(jk, num)))
    for data in (0, 1, 7, 2**31 + 3):
        np.testing.assert_array_equal(R.fold_in(tk, data).numpy(), _words(jax.random.fold_in(jk, data)))
    # batched keys: elementwise over the leading axes, data broadcast
    jb, tb = _keys(seed, 6)
    np.testing.assert_array_equal(R.split(tb, 3).numpy(), _words(jax.vmap(lambda k: jax.random.split(k, 3))(jb)))
    t = torch.arange(4)
    want = jax.vmap(lambda k: jax.vmap(lambda d: jax.random.fold_in(k, d))(jnp.arange(4)))(jb)
    np.testing.assert_array_equal(R.fold_in(tb[:, None], t[None]).numpy(), _words(want))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_draws_match_jax_random(seed, n, dtypes):
    jd, td = dtypes
    jk, tk = _keys(seed, 300)
    ju = jax.vmap(lambda k: jax.random.uniform(k, (n,), jd, -1.0, 1.0))(jk)
    np.testing.assert_array_equal(R.uniform(tk, n, td, -1.0, 1.0).numpy(), np.asarray(ju))
    ju01 = jax.vmap(lambda k: jax.random.uniform(k, (n,), jd))(jk)
    np.testing.assert_array_equal(R.uniform(tk, n, td).numpy(), np.asarray(ju01))
    jn = jax.vmap(lambda k: jax.random.normal(k, (n,), jd))(jk)
    np.testing.assert_allclose(R.normal(tk, n, td).numpy(), np.asarray(jn), rtol=0, atol=NORMAL_ATOL[td])
    je = jax.vmap(lambda k: jax.random.exponential(k, (n,), jd))(jk)
    np.testing.assert_allclose(R.exponential(tk, n, td).numpy(), np.asarray(je), rtol=0, atol=EXP_ATOL[td])


def test_scalar_shape_draw_is_the_first_counter():
    """A draw of shape ``()`` uses counter 0, the first of an ``(n,)`` draw."""
    jk, tk = _keys(3, 16)
    je = jax.vmap(lambda k: jax.random.exponential(k, (), jnp.float64))(jk)
    np.testing.assert_allclose(R.exponential(tk, 1, torch.float64)[:, 0].numpy(), np.asarray(je), rtol=0, atol=5e-14)


def test_draws_keep_their_statistics():
    _, tk = _keys(9, 20000)
    z = R.normal(tk, 2, torch.float64)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    u = R.uniform(tk, 1, torch.float32)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_key_contract():
    with pytest.raises(ValueError, match="int64"):
        R.split(torch.zeros(4, 2))
    with pytest.raises(ValueError, match="float32 or float64"):
        R.normal(R.PRNGKey(0, device="cpu"), 2, torch.float16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            R.PRNGKey(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_normal_does_not_depend_on_the_thread_count(dtype):
    """On the CPU ``normal``'s erfinv runs in slices on the calling thread:
    a (16, 1,024, 4) sensor-slab-sized draw is bit for bit the same with one
    intra-op thread and with several, and equals one erfinv call over the
    whole draw on one thread."""
    _, tk = _keys(12, 16 * 1024)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = R.normal(tk, 4, dtype)
        whole = torch.special.erfinv(R.uniform(tk, 4, dtype, float(np.nextafter(-1.0, 0.0, dtype=np.float64)
                                                                   if dtype == torch.float64 else
                                                                   np.nextafter(np.float32(-1), np.float32(0))),
                                               1.0))
        torch.set_num_threads(max(threads, 4))
        many = [R.normal(tk, 4, dtype) for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    for draw in many:
        assert torch.equal(draw, one)
    nd = np.float32 if dtype == torch.float32 else np.float64
    assert torch.equal(one, whole * float(nd(np.sqrt(2))))


# ---------------------------------------------------------------------------
# what the trainers draw: permutation, randint, shaped draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 70000, 4194304])
def test_permutation_matches_jax_bit_for_bit(n):
    """``ceil(3 ln n / ln(2**32 - 1))`` rounds: 0 at n = 1, 1 up to 2**10.7,
    2 at 70,000, 3 at 2**22 (B = 65,536 x 64), where a round's ~2,000 tied
    sort keys make the stable order decide the result."""
    jk, _ = _keys(5, 1)
    tk = torch.as_tensor(_words(jk[0]))
    ours = R.permutation(tk, n)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax.random.permutation(jk[0], n)))
    assert ours.dtype == torch.int64 and torch.equal(torch.sort(ours).values, torch.arange(n))


def test_permutation_of_a_batch_of_keys_matches_vmap():
    jk, tk = _keys(6, 4)
    want = jax.vmap(lambda k: jax.random.permutation(k, 1000))(jk)
    np.testing.assert_array_equal(R.permutation(tk, 1000).numpy(), np.asarray(want))


@pytest.mark.parametrize("span", [1, 3, 1000, 2**20 + 7, 2**31 - 3])
@pytest.mark.parametrize("dtypes", [(jnp.int64, torch.int64), (jnp.int32, torch.int32)], ids=["int64", "int32"])
def test_randint_matches_jax_bit_for_bit(span, dtypes):
    jd, td = dtypes
    jk, tk = _keys(7, 3)
    lo = -2
    want = jax.vmap(lambda k: jax.random.randint(k, (4000,), lo, lo + span, dtype=jd))(jk)
    ours = R.randint(tk, 4000, lo, lo + span, td)
    assert ours.dtype == td
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    assert int(ours.min()) >= lo and int(ours.max()) < lo + span


def test_randint_contract():
    _, tk = _keys(8, 2)
    assert bool((R.randint(tk, 5, 3, 3) == 3).all())  # maxval <= minval returns minval
    with pytest.raises(ValueError, match="2\\*\\*31"):
        R.randint(tk, 5, 0, 2**31 + 1)
    with pytest.raises(ValueError, match="int32 or int64"):
        R.randint(tk, 5, 0, 10, torch.int16)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_shaped_draws_number_their_elements_in_row_major_order(dtypes):
    """``normal(key, (B, A))`` and ``uniform(key, (B, A), dtype, -1, 1)`` as
    the trainers draw them (utils/rl.py, utils/sac.py)."""
    jd, td = dtypes
    jk, _ = _keys(4, 1)
    tk = torch.as_tensor(_words(jk[0]))
    np.testing.assert_allclose(R.normal(tk, (17, 3), td).numpy(), np.asarray(jax.random.normal(jk[0], (17, 3), jd)),
                               rtol=0, atol=NORMAL_ATOL[td])
    np.testing.assert_array_equal(R.uniform(tk, (17, 3), td, -1.0, 1.0).numpy(),
                                  np.asarray(jax.random.uniform(jk[0], (17, 3), jd, -1.0, 1.0)))
    np.testing.assert_array_equal(R.random_bits(tk, (5, 2)).numpy(),
                                  np.asarray(jax.random.bits(jk[0], (5, 2), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("bounds", [(0.1, 0.2), (15e-3, 21e-3), (-0.4, 0.4), (-3e5, 7.1)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_uniform_over_any_span_is_the_fused_multiply_add(bounds, dtypes):
    jd, td = dtypes
    jk, tk = _keys(9, 4)
    want = jax.vmap(lambda k: jax.random.uniform(k, (20000,), jd, *bounds))(jk)
    np.testing.assert_array_equal(R.uniform(tk, 20000, td, *bounds).numpy(), np.asarray(want))


@pytest.mark.parametrize("n_values", [1, 3, 1000])
@pytest.mark.parametrize("with_p", [False, True], ids=["uniform", "p"])
@pytest.mark.parametrize("x64", [True, False], ids=["x64", "x32"])
def test_choice_matches_jax_bit_for_bit(n_values, with_p, x64):
    """``jax.random.choice(key, values, (n,), replace=True, p=p)`` in JAX's
    default dtypes: float64 values and 64-bit indices under x64, float32 and
    32-bit ones without (the port takes the width from the values).  Bit for
    bit, but for float32 ``p`` over 1,000 values: XLA evaluates ``cumsum`` on
    the CPU as a rewritten reduce-window whose float32 sums differ from the
    sequential sum by a few ulps (892 of the 1,000 partial sums here), so a
    draw within those ulps of a boundary takes the neighbouring value; at
    most 4 of 4,096 draws, each one index away."""
    rng = np.random.default_rng(n_values)
    values = rng.uniform(-5, 5, n_values)
    p = rng.uniform(0.1, 1.0, n_values) if with_p else None
    if with_p:
        p = p / p.sum()
    td = torch.float64 if x64 else torch.float32
    for seed in SEEDS[:3]:
        jk = jax.random.PRNGKey(seed)
        with jax.enable_x64(x64):
            want = jax.random.choice(jk, jnp.asarray(values), (4096,), p=None if p is None else jnp.asarray(p))
            want = np.asarray(want)
        got = R.choice(torch.as_tensor(_words(jk)), torch.as_tensor(values, dtype=td), 4096, p=p)
        assert got.dtype == td
        if x64 or not with_p or n_values < 1000:
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        order = np.argsort(values.astype(np.float32))
        index = lambda v: order[np.searchsorted(values.astype(np.float32)[order], v)]
        apart = np.abs(index(got.numpy()) - index(want))
        assert int((apart > 0).sum()) <= 4 and int(apart.max()) <= 1


def test_choice_contract():
    _, tk = _keys(3, 2)
    vals = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    assert R.choice(tk, vals, (5, 7)).shape == (2, 5, 7)
    assert set(R.choice(tk, vals, 500, p=[0.0, 1.0, 0.0]).unique().tolist()) == {2.0}
    with pytest.raises(ValueError, match="1-D"):
        R.choice(tk[0], torch.zeros((2, 2)), 3)
    with pytest.raises(ValueError, match="length"):
        R.choice(tk[0], vals, 3, p=[0.5, 0.5])
