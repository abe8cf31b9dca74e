"""examples/kmer_experiments.py on the port against the JAX example
(examples/kmer_experiments.py, whose own tests are
tests/test_kmer_experiments.py).

The batches are numpy from the same seed on both sides, so the helpers
must agree to the bit. Each experiment inits inside; the port's run starts
from JAX's initial parameters through a patch of the port's init hook
(``_mapping_init``, ``_stay_init``, ``_decode_init``), which the test
captures from JAX's ``optax.adamax(...).init`` (and, for ``decode``, JAX's
frozen k-mer embedding, normal(1) from fold_in(PRNGKey(seed), 1)). Rule for
all three: each of the first 3 losses within rtol 1e-4 of JAX's (the port's
through its callback, JAX's recorded from its jitted step). Adamax's
sign-like first update did not turn float32 rounding into a larger gap at
these sizes (mapping equal to the bit, stay 2.8e-6, decode 1e-7 apart at
step 3), so no float64 yardstick is needed here, unlike
tests/test_torch_pretrain.py. Then the JAX test's own property on the port
from its own init: ``decode`` learns (40 steps, CE below 1.2, chance ln 4).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (a fixture)
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.examples import kmer_experiments as ke

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import kmer_experiments as jke  # noqa: E402

LOSS_RTOL = 1e-4

pytestmark = pytest.mark.usefixtures("one_thread")


def test_nts_to_kmers_matches_jax(rng):
    nts = rng.integers(1, 5, size=(6, 40))
    got, want = ke._nts_to_kmers(nts), jke._nts_to_kmers(nts)
    assert got.dtype == want.dtype and got.shape == (6, 36)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ke._kmer_tables()[0], jke._kmer_tables()[0])
    np.testing.assert_array_equal(ke._kmer_tables()[1], jke._kmer_tables()[1])


def test_stay_batch_matches_jax():
    args = (3, 5, 2.0, 0.5, 4, 20)
    got = ke._stay_batch(np.random.default_rng(0), *ke._kmer_tables(), *args)
    want = jke._stay_batch(np.random.default_rng(0), *jke._kmer_tables(), *args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sig, lab, valid = got
    assert (lab[:, 0] < 1024).all() and ((lab == 1024) & valid).any()
    assert (sig[~valid] == 0).all()


@pytest.fixture
def jax_inits(monkeypatch):
    """JAX's initial params, as each run_* hands them to optax.adamax's init."""
    seen = []
    real = optax.adamax

    def adamax(lr):
        tx = real(lr)

        def init(params):
            seen.append(jax.tree_util.tree_map(np.asarray, params))
            return tx.init(params)

        return optax.GradientTransformation(init, tx.update)

    monkeypatch.setattr(optax, "adamax", adamax)
    return seen


def _on_device(state_dict, module):
    dev = next(module.parameters()).device
    return {k: v.to(dev) for k, v in state_dict.items()}


EXPERIMENTS = {
    "mapping": dict(run="run_mapping", kw=dict(batch_size=16, nhid=32, lr=2e-3, seed=0)),
    "stay": dict(run="run_stay", kw=dict(batch_size=4, num_features=16, lr=1e-3, seed=0)),
    "decode": dict(run="run_decode", kw=dict(batch_size=4, nt_length=30, channels=16,
                                             enc_dim=32, lr=3e-3, seed=0)),
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_three_steps_from_jax_init_match_jax(name, jax_inits, monkeypatch):
    run, kw = EXPERIMENTS[name]["run"], EXPERIMENTS[name]["kw"]
    want, real_jit = [], jax.jit

    def jit(fn, **jit_kw):   # records the loss of each call of JAX's step
        jitted = real_jit(fn, **jit_kw)
        if fn.__name__ != "step":
            return jitted

        def step(*args):
            out = jitted(*args)
            want.append(float(out[-1]))
            return out

        return step

    monkeypatch.setattr(jax, "jit", jit)
    assert getattr(jke, run)(steps=3, **kw) == want[-1] and len(want) == 3
    monkeypatch.setattr(jax, "jit", real_jit)
    jparams = jax_inits[0]
    if name == "mapping":
        monkeypatch.setattr(ke, "_mapping_init", lambda dims, seed: bridge.mlp_from_jax(jparams))
    elif name == "stay":
        monkeypatch.setattr(ke, "_stay_init", lambda net, seed: _on_device(
            bridge.raw_ctcnet_from_jax(jparams), net))
    else:
        embed = np.asarray(jax.nn.initializers.normal(1.0)(
            jax.random.fold_in(jax.random.PRNGKey(kw["seed"]), 1), (1024, kw["enc_dim"]),
            jnp.float32))
        monkeypatch.setattr(ke, "_decode_init", lambda dec, seed, enc_dim: (
            _on_device(bridge.decoder_from_jax(jparams), dec), torch.from_numpy(embed.copy())))
    losses = []
    last = getattr(ke, run)(steps=3, device="cpu", callback=lambda k, l: losses.append(float(l)),
                            **kw)
    assert last == losses[-1] and len(losses) == 3
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_init_hooks_are_seeded_and_shaped():
    """The port's own init: one seed, the same parameters twice, in the
    example's layer shapes (mapping: sparse normal(0.01) with ~10% zeros;
    the three-step tests load JAX's params into these shapes)."""
    dims = [1, 1] + [32] * 6 + [1024]
    a, b = ke._mapping_init(dims, 3), ke._mapping_init(dims, 3)
    assert [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in a] == \
        [((i, o), (o,)) for i, o in zip(dims[:-1], dims[1:])]
    for la, lb in zip(a, b):
        assert torch.equal(la["w"], lb["w"]) and torch.equal(la["b"], lb["b"])
    w = torch.cat([l["w"].reshape(-1) for l in a])
    assert 0.05 < float((w == 0).float().mean()) < 0.15
    assert abs(float(w[w != 0].std()) - 0.01) < 1e-3


def test_decode_learns_quickly():
    """JAX's test (tests/test_kmer_experiments.py:38-41) on the port from
    its own init."""
    loss = ke.run_decode(steps=40, batch_size=8, nt_length=40, channels=32,
                         enc_dim=64, lr=3e-3, seed=0, device="cpu")
    assert np.isfinite(loss) and loss < 1.2  # chance is log(4) ~ 1.386


def test_main_runs_each_experiment_on_the_cpu(capsys):
    for exp in ("mapping", "stay", "decode"):
        out = ke.main([exp, "--steps", "2", "--batch-size", "2", "--device", "cpu"])
        assert np.isfinite(out)
    text = capsys.readouterr().out
    assert "final CE" in text and "final frame CE" in text and "final next-nt CE" in text
