"""Fast incremental WaveNet generation (models/fast_wavenet.py) against the
JAX package's, and against the port's own parallel forward, with the JAX
params carried over by ``bridge.wavenet_from_jax``.

Tolerance: probabilities within rtol 1e-4, atol 1e-5 (as JAX's own test
holds its generation to its parallel forward). Argmax feedback is held by
the margin rule of test_torch_ar_decoders.py: where the port's levels and
JAX's differ, the first difference falls on a step whose top-2 margin in
JAX's probabilities is below twice the tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ar_decoders import check_margin_rule
from wavenet_speech_tpu.models import WaveNet as JWaveNet
from wavenet_speech_tpu.models.fast_wavenet import generate as jgenerate
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models import WaveNet, fast_wavenet

TOL = dict(rtol=1e-4, atol=1e-5)
C = 16   # levels in and out


def _port_model(layers, entry_kwidth=2, seed=0):
    """The port's WaveNet from its own init (JAX's distributions)."""
    tnet = WaveNet(C, entry_kwidth, layers, C, softmax=False)
    tnet.reset_parameters(torch.Generator().manual_seed(seed))
    return tnet.eval()


def _prime(B, L0, seed):
    lv = np.random.default_rng(seed).integers(0, C, size=(B, L0))
    return np.eye(C, dtype=np.float32)[lv]


def _parallel_probs(tnet, prime, levels):
    """softmax of the port's parallel forward over prime + the generated
    levels, one-hot: position L0-1+j predicts generated step j."""
    x = torch.cat([torch.from_numpy(prime),
                   torch.nn.functional.one_hot(levels, C).float()], dim=1)
    with torch.no_grad():
        out = torch.softmax(tnet(x), dim=-1)
    return out[:, prime.shape[1] - 1:-1]


MIXED = ((8, 8, 3, 1), (8, 8, 2, 2), (8, 8, 5, 2), (8, 8, 3, 4))


def test_argmax_generation_matches_jax():
    """A k = 2 / 3 / 5 mix of blocks after a k = 3 entry conv. (The bridge
    unrolls cycle-stacked params, tests/test_torch_models.py; the port's
    generation sees unrolled blocks either way.)"""
    jnet = JWaveNet(C, 3, MIXED, C, softmax=False)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0))   # one compile, not one an array
    tnet = WaveNet(C, 3, MIXED, C, softmax=False)
    tnet.load_state_dict(bridge.wavenet_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    prime, T = _prime(2, 7, 1), 10
    jlevels, jprobs = (np.asarray(a) for a in jax.jit(jgenerate, static_argnums=(0, 3))(
        jnet, params, jnp.asarray(prime), T))
    levels, probs = fast_wavenet.generate(tnet, torch.from_numpy(prime), T)
    assert levels.shape == (2, T) and probs.shape == (2, T, C)
    if not len(check_margin_rule(jprobs, jlevels, levels.numpy(), TOL)):
        np.testing.assert_array_equal(levels.numpy(), jlevels)
        np.testing.assert_allclose(probs.numpy(), jprobs, **TOL)


@pytest.mark.parametrize("layers,ke,B,L0", [
    (tuple((8, 8, 2, d) for d in (1, 2, 4)), 2, 2, 6),
    (MIXED, 3, 2, 7),
    (((8, 8, 3, 2),), 4, 1, 1),       # a prime shorter than the entry kernel and the ring
    (tuple((8, 8, 2, d) for d in (1, 2, 4, 8)), 2, 3, 3)])   # shorter than the d=8 ring
def test_incremental_matches_parallel_forward(layers, ke, B, L0):
    """Each generated step's probabilities equal the port's parallel
    forward over prime + generated levels at the position before it, and
    its level is that forward's argmax (margin rule)."""
    tnet = _port_model(layers, ke, seed=2)
    prime = _prime(B, L0, 3)
    levels, probs = fast_wavenet.generate(tnet, torch.from_numpy(prime), 9)
    want = _parallel_probs(tnet, prime, levels)
    np.testing.assert_allclose(probs.numpy(), want.numpy(), **TOL)
    assert not len(check_margin_rule(want.numpy(), want.argmax(-1).numpy(), levels.numpy(),
                                     TOL))


def test_sampling_path():
    """A fixed generator reproduces its draws; every level is in range and
    the probabilities sum to 1; the draws follow the parallel forward; as
    the temperature goes to 0 the draw is the argmax."""
    tnet = _port_model(tuple((8, 8, 2, d) for d in (1, 2)), seed=4)
    prime = torch.from_numpy(_prime(3, 5, 5))
    run = lambda seed, temp: fast_wavenet.generate(
        tnet, prime, 12, generator=torch.Generator().manual_seed(seed), temperature=temp)
    (a, pa), (b, pb) = run(7, 0.8), run(7, 0.8)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert ((a >= 0) & (a < C)).all()
    np.testing.assert_allclose(pa.sum(-1).numpy(), 1.0, rtol=1e-5)
    with torch.no_grad():
        logits = tnet(torch.cat([prime, torch.nn.functional.one_hot(a, C).float()], 1))
    np.testing.assert_allclose(pa.numpy(), torch.softmax(logits[:, 4:-1] / 0.8, -1).numpy(),
                               **TOL)
    cold, _ = run(8, 1e-6)
    argmax, _ = fast_wavenet.generate(tnet, prime, 12)
    assert torch.equal(cold, argmax)


def test_one_hot_feedback_needs_in_dim_equal_out_dim():
    tnet = WaveNet(C, 2, ((8, 8, 2, 1),), C + 1, softmax=False)
    with pytest.raises(ValueError, match="in_dim == out_dim"):
        fast_wavenet.generate(tnet, torch.zeros((1, 3, C)), 2)


def test_zero_steps_primes_only():
    """num_steps 0 runs the priming alone (chip_smoke times it so) and
    returns empty levels and probabilities."""
    tnet = _port_model(tuple((8, 8, 2, d) for d in (1, 2)), seed=6)
    levels, probs = fast_wavenet.generate(tnet, torch.from_numpy(_prime(2, 4, 6)), 0)
    assert levels.shape == (2, 0) and levels.dtype == torch.long and probs.shape == (2, 0, C)
