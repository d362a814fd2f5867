"""The port's attention paths (repro_torch/models/layers.py) against the
JAX package's (``repro.models.layers``) and against each other — the twin
of tests/test_attention_impls.py.

The same numpy inputs go through ``repro.models.layers.attention`` and
the port's dispatcher for every execution path (full, chunked, masked,
triangle), causal or not (the enc-dec encoder and cross-attention are
non-causal), with and without a sliding window, at GQA rep 1 and 4, in
float32; each path equals the reference's within the reference test's
1e-5 (1e-4 on its random-shape property case), and the port's full
attention wherever the reference's paths agree with each other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are tiny: one intra-op thread computes them as fast,
    and the test workers running beside this one keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, s, hq, hkv, d, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("impl", ["full", "chunked", "masked", "triangle"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_attention_matches_reference(impl, causal, window, hq, hkv):
    """Every path of the dispatcher equals the reference's same path
    within 1e-5 (triangle falls back to the dispatcher's ``auto`` rule
    where it does not apply, as in both packages), and the port's full
    attention — except a non-causal windowed chunked path, which visits
    one causal window slice a query chunk in the reference as in the
    port (no model runs it: every sliding window is causal)."""
    q, k, v = _qkv(hq * 10 + window, 2, 256, hq, hkv, 32)
    kw = dict(causal=causal, window=window, impl=impl, q_chunk=64,
              kv_chunk=64)
    want = np.asarray(jlayers.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw))
    got = layers.attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if window and not causal and impl in ("chunked", "masked"):
        return
    full = layers.attention_full(_t(q), _t(k), _t(v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_cross_attention_shape_matches_reference():
    """Non-causal attention of S queries over T != S keys (the enc-dec
    cross-attention, ``impl="full"``) equals the reference's."""
    q, k, v = _qkv(5, 2, 24, 4, 4, 16, t=60)
    want = np.asarray(jlayers.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False,
                                        impl="full"))
    got = layers.attention(_t(q), _t(k), _t(v), causal=False, impl="full")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_window_truly_limits_receptive_field():
    """Perturbing a key outside the window must not change the output."""
    q, k, v = (_t(a) for a in _qkv(2, 1, 256, 2, 2, 16))
    w = 32
    out1 = layers.attention_chunked(q, k, v, causal=True, window=w,
                                    q_chunk=64, kv_chunk=64)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10] += 100.0            # position 10 is outside window of q>=42+
    v2[:, 10] += 100.0
    out2 = layers.attention_chunked(q, k2, v2, causal=True, window=w,
                                    q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(out1[:, 10 + w:].numpy(),
                               out2[:, 10 + w:].numpy(), atol=1e-5)


@pytest.mark.parametrize("s,hq,seed", [(64, 2, 11), (128, 4, 12),
                                       (192, 2, 13), (192, 4, 14)])
def test_chunked_matches_full_across_shapes(s, hq, seed):
    """The reference's property case at fixed draws: chunked equals full
    within 1e-4."""
    q, k, v = (_t(a) for a in _qkv(seed, 1, s, hq, hq, 16))
    full = layers.attention_full(q, k, v, causal=True)
    chunked = layers.attention_chunked(q, k, v, causal=True, q_chunk=64,
                                       kv_chunk=64)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_decode_with_kv_len_matches_prefix_and_reference():
    """Masked decode over a padded cache equals attention over the true
    prefix, and the reference's masked decode."""
    q, k, v = _qkv(3, 2, 1, 2, 2, 16, t=64)
    n_valid = 40
    kw = dict(causal=True, q_offset=n_valid - 1)
    masked = layers.attention_full(_t(q), _t(k), _t(v), kv_len=n_valid, **kw)
    exact = layers.attention_full(_t(q), _t(k[:, :n_valid]),
                                  _t(v[:, :n_valid]), **kw)
    np.testing.assert_allclose(masked.numpy(), exact.numpy(), atol=1e-5)
    want = np.asarray(jlayers.attention_full(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(n_valid), **kw))
    np.testing.assert_allclose(masked.numpy(), want, atol=1e-5)
