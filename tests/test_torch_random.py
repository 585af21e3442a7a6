"""The port's threefry PRNG against jax.random, bit for bit, at the call
sites' functions (split, fold_in, raw bits, randint, choice, permutation)
over several seeds and shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import random as jr
from _torch_threads import one_torch_thread  # noqa: F401


SEEDS = [0, 2, 42, 1347, 2 ** 31 + 5]


def _np(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (2, 3, 7):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      jr.split(tk, num).numpy())
    for data in (0, 7, 9, 123457, 2 ** 32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, data)),
                                      jr.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (8,), (3, 5)])
def test_bits_and_randint(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(
        _np(jax.random.bits(jk, shape, jnp.uint32)),
        jr.random_bits(tk, shape).numpy())
    for lo, hi in ((0, 230), (0, 1200), (5, 100_000), (0, 1), (-7, 3)):
        np.testing.assert_array_equal(
            _np(jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32)),
            jr.randint(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_ints_matches(seed):
    """The host replay's draw on a key held as two ints."""
    jk = jax.random.PRNGKey(seed)
    key = tuple(int(k) for k in _np(jk))
    for f in (230, 2, 921):
        np.testing.assert_array_equal(
            _np(jax.random.randint(jk, (8,), 0, f, dtype=jnp.int32)),
            jr.randint_ints(key, 8, 0, f))
    np.testing.assert_array_equal(
        _np(jax.random.split(jk)),
        np.array(jr.split_ints(key)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [5, 1200, 70_000])
def test_permutation_and_choice(seed, n):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jax.random.permutation(jk, n)),
                                  jr.permutation(tk, n).numpy())
    k = min(n, 300)
    np.testing.assert_array_equal(
        _np(jax.random.choice(jk, n, (k,), replace=False)),
        jr.choice(tk, n, (k,), replace=False).numpy())
    np.testing.assert_array_equal(
        _np(jax.random.choice(jk, n, (9,))), jr.choice(tk, n, (9,)).numpy())


def test_fold_in_takes_data_mod_2_32():
    """A maintenance pass folds ``count * 131071 + n_deleted`` into its
    key, past 2**32 - 1 at any count from 32,769: ``jax.random.fold_in``
    raises there (ROADMAP queue 3), and the port takes the data mod 2**32,
    which is jax's key wherever jax has one."""
    jk, tk = jax.random.PRNGKey(1347), jr.PRNGKey(1347)
    assert 32_769 * 131071 > 2 ** 32 - 1 >= 32_768 * 131071 + 32_767
    for data in (32_769 * 131071, 101_200 * 131071 + 20_241, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jk, data)
        np.testing.assert_array_equal(
            _np(jax.random.fold_in(jk, data % 2 ** 32)),
            jr.fold_in(tk, data).numpy())
