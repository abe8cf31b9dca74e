"""The port's WaveNet, WaveNetClassifier and facade Model against the JAX
package, with JAX params carried over by the bridge in both stack layouts
(unrolled ``blocks/{i}`` and cycle-stacked ``cycle/b{j}``). Tolerance:
rtol 1e-4, atol 1e-5 — sums over several blocks in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu.models import WaveNet as JWaveNet
from wavenet_speech_tpu.models import WaveNetClassifier as JClassifier
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.models import WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.training import build_optimizer, make_joint_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
C = 16


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _onehot(B, L, levels, seed):
    lv = np.random.default_rng(seed).integers(0, levels, size=(B, L))
    return np.eye(levels, dtype=np.float32)[lv]


@pytest.mark.parametrize("scan_cycles", [True, False])
def test_wavenet_matches_jax(scan_cycles):
    layers = tuple((C, C, 2, d) for d in (1, 2, 4) * 2)  # a cycle of 3, twice
    jnet = JWaveNet(C, 2, layers, C, softmax=False, scan_cycles=scan_cycles)
    params = jnet.init(jax.random.PRNGKey(0))
    assert ("cycle" in params["stack"]) == scan_cycles
    tnet = WaveNet(C, 2, layers, C, softmax=False, device="cpu")
    tnet.load_state_dict(bridge.wavenet_from_jax(_np_tree(params)))
    x = _onehot(2, 120, C, 0)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jnet.apply(params, jnp.asarray(x))),
                               **TOL)
    assert tnet.receptive_field == jnet.receptive_field


@pytest.mark.parametrize("scan_cycles", [True, False])
@pytest.mark.parametrize("pool", [1, 4])
def test_classifier_matches_jax(scan_cycles, pool):
    layers = tuple((C, C, 2, d) for d in (1, 2) * 2)
    jclf = JClassifier(C, 5, layers, C, pool_kernel_size=pool, softmax=False,
                       scan_cycles=scan_cycles)
    params = jclf.init(jax.random.PRNGKey(1))
    tclf = WaveNetClassifier(C, 5, layers, C, pool_kernel_size=pool,
                             softmax=False, device="cpu")
    tclf.load_state_dict(bridge.classifier_from_jax(_np_tree(params)))
    x = np.random.default_rng(1).standard_normal((2, 103, C)).astype(np.float32)
    with torch.no_grad():
        out = tclf(torch.from_numpy(x))
    ref = np.asarray(jclf.apply(params, jnp.asarray(x)))
    assert out.shape == ref.shape == (2, 103 // pool, 5)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _cfg():
    return {"model": {"base": {"signal_dim": C, "dilations": [1, 2, 4] * 2},
                      "classifier": {"dilations": [1, 2] * 2, "downsample": 4}}}


def test_facade_model_matches_jax():
    """The facade builds cycle-stacked params, the CLI's checkpoint layout."""
    jm = jfacade.Model("wavenet-ctc", _cfg())
    params = jm.init(jax.random.PRNGKey(2))
    tm = Model("wavenet-ctc", _cfg(), device="cpu").load_jax(_np_tree(params))
    x = _onehot(2, 128, C, 2)
    with torch.no_grad():
        base, logits = tm.predict(torch.from_numpy(x))
    jbase, jlogits = jm.predict(params, jnp.asarray(x))
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(x)), logits)


def test_model_init_is_seeded_and_in_bounds():
    a = Model("wavenet-ctc", _cfg(), device="cpu").init(3)
    b = Model("wavenet-ctc", _cfg(), device="cpu").init(3)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    blk = a.model_base.stack.blocks[0]
    assert float(blk.gate_w.detach().abs().max()) <= (6 / (2 * C)) ** 0.5
    assert not blk.gate_b.any()
    assert torch.equal(a.model_base.stack.bottlenecks[0].w, torch.eye(C))
    assert torch.equal(a.model_ctc.input_bottleneck.w, torch.eye(C))
    names = set(a.state_dict())
    want = set(bridge.params_from_jax(_np_tree(
        jfacade.Model("wavenet-ctc", _cfg()).init(jax.random.PRNGKey(0)))))
    assert names == want


def test_model_entry_points_refuse_silent_cpu():
    # raw-ctcnet serves and trains on the CPU when asked
    raw = Model("raw-ctcnet", {"model": {"raw": {"num_features": 4, "out_dim": 4,
                                                  "num_dilation_blocks": 1,
                                                  "dilations": [1]}}}, device="cpu")
    assert raw.device == torch.device("cpu")
    make_joint_train_step(raw.model_base, raw.model_ctc, build_optimizer("adam", 1e-3))
    with pytest.raises(ValueError):
        Model("bogus", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model("wavenet-ctc", _cfg())
