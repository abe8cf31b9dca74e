"""The port's anomaly forensics (wavenet_speech_tpu_torch/training/
diagnostics.py) against the JAX package's (training/diagnostics.py) on the
CPU: the same params (bridged) and batch, the tiny harness model of
tests/test_diagnostics.py (unrolled stack) and a cyclic one (JAX's scan
path).

Held: section_report's stage names, finiteness, gradient groups and
probe check equal JAX's in float32 and bf16; in float32 every max|x|, the
loss, each group's max|g| and sum of squares and the per-cycle maxima
within STAT_RTOL (the same sums in another order). A poisoned out1 (x 1e30)
is localised at or after out1 by both, with every earlier stage finite.
dump_anomaly writes JAX's layout and the same batch and meta, refuses to
overwrite, and stops at max_dumps; load_anomaly gives the params back."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.gaussian_eval import build_model as jax_build_model
from wavenet_speech_tpu.data import RawGaussianModelLoader
from wavenet_speech_tpu.models import RawCTCNet as JRawCTCNet
from wavenet_speech_tpu.ops.norm import batch_standardize as jax_batch_standardize
from wavenet_speech_tpu.training import diagnostics as jdiag
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.examples.gaussian_eval import build_model
from wavenet_speech_tpu_torch.models import RawCTCNet
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training import diagnostics as diag

STAT_RTOL = 1e-4
AFTER_OUT1 = ("out1", "logits", "ctc_per_seq", "loss", "global_norm_sumsq")
CYCLIC = tuple((24, 24, 2, d) for d in (1, 2, 4)) * 3   # tests/test_diagnostics.py's


def torch_params(jax_params):
    return bridge.raw_ctcnet_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


@pytest.fixture(scope="module")
def batch():
    loader = RawGaussianModelLoader(
        max_iters=10, num_epochs=10, epoch_size=10, batch_size=3, upsampling=6,
        random_upsample=False, lengths=(15, 18), seed=0, pad_to=(18 - 1 - 8) * 6,
        labels_pad_to=17)
    b = loader.fetch()
    return {"signal": b.signal, "labels": b.labels, "label_lengths": b.label_lengths,
            "signal_lengths": b.signal_lengths}


def models(kind):
    """(JAX model, its params, the port's model) of one stack kind."""
    if kind == "unrolled":
        jm = jax_build_model(1 / 64, remat=False)
        net = build_model(1 / 64, device="cpu")
    else:
        jm = JRawCTCNet(32, 3, 5, CYCLIC, 24, positions=False, softmax=False, causal=False)
        net = RawCTCNet(32, 3, 5, CYCLIC, 24, positions=False, softmax=False, causal=False)
    return jm, jm.init(jax.random.PRNGKey(1)), net


def reports(kind, batch, dtypes, poison=False):
    jm, jp, net = models(kind)
    pp = torch_params(jp)
    if poison:
        jp = dict(jp, out1={"w": jp["out1"]["w"] * 1e30, "b": jp["out1"]["b"]})
        pp = dict(pp, **{"out1.w": pp["out1.w"] * 1e30})
    want = jdiag.section_report(jm, jp, batch, compute_dtype=dtypes[0],
                                preprocess=jax_batch_standardize)
    got = diag.section_report(net, pp, batch, compute_dtype=dtypes[1],
                              preprocess=batch_standardize)
    return jm, got, want


DTYPES = {"float32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["unrolled", "cyclic"])
def test_section_report_matches_jax(kind, dtype, batch):
    jm, got, want = reports(kind, batch, DTYPES[dtype])
    assert [s[:2] for s in got["stages"]] == [s[:2] for s in want["stages"]]
    assert [s[0] for s in got["stages"]] == jdiag._stage_names(
        jm, jm._stack()._scan_config()[2]) + ["ctc_per_seq"]
    assert list(got["grads"]) == list(want["grads"])
    assert {k: v["finite"] for k, v in got["grads"].items()} == \
        {k: v["finite"] for k, v in want["grads"].items()}
    assert got["probe_matches_model_apply"] and want["probe_matches_model_apply"]
    assert len(got["per_cycle_max_out"]) == len(want["per_cycle_max_out"]) == \
        len(got["per_cycle_max_skips"]) == (3 if kind == "cyclic" else len(jm.layers))
    assert diag.first_nonfinite(got) is None and jdiag.first_nonfinite(want) is None
    assert set(got) == set(want) and got["compute_dtype"] == ("bfloat16" if dtype == "bf16"
                                                            else "float32")
    if dtype == "bf16":
        return
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=STAT_RTOL)
    close([s[2] for s in got["stages"]], [s[2] for s in want["stages"]])
    close(got["loss"], want["loss"])
    close(got["per_cycle_max_out"], want["per_cycle_max_out"])
    close(got["per_cycle_max_skips"], want["per_cycle_max_skips"])
    for k, v in want["grads"].items():
        np.testing.assert_allclose([got["grads"][k]["max_abs"], got["grads"][k]["sumsq_f32"]],
                                   [v["max_abs"], v["sumsq_f32"]], rtol=1e-3)
    close(got["gnorm_sumsq_f32"], want["gnorm_sumsq_f32"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_poisoned_out1_is_localised_at_or_after_out1(dtype, batch):
    """out1.w x 1e30: the activations still fit in float32 and bf16; what
    goes non-finite first comes at or after out1 in both packages, and
    every stage before out1 stays finite with the same max|x|. JAX's
    autodiff CTC keeps the gradients finite and overflows the float32 sum of
    squares ('global_norm_sumsq'); the port's alpha-beta CTC backward (JAX's
    Pallas form) turns logits of 1e30 into NaN gradients ('grad:...')."""
    _, got, want = reports("unrolled", batch, DTYPES[dtype], poison=True)
    for rep, site in ((got, diag.first_nonfinite(got)), (want, jdiag.first_nonfinite(want))):
        assert site in AFTER_OUT1 or site.startswith("grad:"), site
        stages = [s[0] for s in rep["stages"]]
        assert all(f for _, f, _ in rep["stages"][:stages.index("out1")])
        assert rep["probe_matches_model_apply"]
    n = [s[0] for s in want["stages"]].index("out1")
    assert [s[:2] for s in got["stages"][:n + 2]] == [s[:2] for s in want["stages"][:n + 2]]
    if dtype == "float32":
        np.testing.assert_allclose([s[2] for s in got["stages"][:n + 2]],
                                   [s[2] for s in want["stages"][:n + 2]], rtol=STAT_RTOL)


class HostBatch:
    """The host Batch the harness passes."""

    def __init__(self, d):
        self.__dict__.update(d)


def test_dump_layout_and_round_trip_match_jax(batch, tmp_path):
    jm, jp, net = models("unrolled")
    pp = torch_params(jp)
    extra = {"ctc_loss": float("inf"), "grad_norm": 1e9}
    want = jdiag.dump_anomaly(str(tmp_path / "jax"), HostBatch(batch), jp, 123, "nonfinite", extra)
    got = diag.dump_anomaly(str(tmp_path / "port"), HostBatch(batch), pp, 123, "nonfinite", extra)
    assert os.path.basename(got) == os.path.basename(want) == "step_123_nonfinite"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == ["batch.npz", "meta.json",
                                                                   "params"]
    assert os.path.isdir(os.path.join(got, "params"))
    with np.load(os.path.join(got, "batch.npz")) as g, np.load(os.path.join(want, "batch.npz")) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k])
    meta = [json.loads(open(os.path.join(p, "meta.json")).read()) for p in (got, want)]
    assert meta[0] == meta[1]
    # the same step again is refused (a re-run of the failing step)
    assert diag.dump_anomaly(str(tmp_path / "port"), HostBatch(batch), pp, 123, "nonfinite") is None
    b2, p2 = diag.load_anomaly(got, {k: torch.zeros_like(v) for k, v in pp.items()})
    np.testing.assert_array_equal(b2["signal"], batch["signal"])
    assert all(torch.equal(p2[k], pp[k]) for k in pp)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}   # tensors dump too
    for s in (124, 125, 126):
        diag.dump_anomaly(str(tmp_path / "port"), tensors, pp, s, "spike", max_dumps=3)
    assert sorted(os.listdir(tmp_path / "port")) == ["step_123_nonfinite", "step_124_spike",
                                                     "step_125_spike"]


def test_first_nonfinite_order():
    rep = {"stages": [("feat_conv", True, 1.0), ("out1", False, np.inf)], "loss": np.nan,
           "grads": {"a": {"finite": False}}, "gnorm_sumsq_f32": np.inf}
    assert diag.first_nonfinite(rep) == jdiag.first_nonfinite(rep) == "out1"
    rep["stages"][1] = ("out1", True, 1.0)
    assert diag.first_nonfinite(rep) == "loss"
    rep["loss"] = 1.0
    assert diag.first_nonfinite(rep) == "grad:a"
    rep["grads"]["a"]["finite"] = True
    assert diag.first_nonfinite(rep) == jdiag.first_nonfinite(rep) == "global_norm_sumsq"
    assert diag.scan_config(CYCLIC) == (3, 3, True)
    assert diag.scan_config(models("unrolled")[0].layers)[2] is False
