"""The JSON config system, copied from wavenet_speech_tpu/utils/config.py
(pure Python; the port cannot import that package, whose __init__ imports
jax): the readers of the model and training blocks, with the same
defaults.

Accepts both reference layer-spec styles:
  * explicit "layers": [[c_in, c_out, k, d], ...]
  * "kernel" + "dilations": [...] (+ "signal_dim"/channel default)
"""
from __future__ import annotations

import json
from typing import Any, Dict, Tuple


def json_to_config(json_path: str) -> Dict[str, Any]:
    with open(json_path, "r") as jf:
        return json.load(jf)


def config_to_json(cfg: Dict[str, Any], json_path: str) -> None:
    with open(json_path, "w") as jf:
        json.dump(cfg, jf, indent=4, sort_keys=True)


def layers_from_cfg(cfg: Dict[str, Any], channels: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """Build layer quadruples from either schema style."""
    if "layers" in cfg and cfg["layers"]:
        return tuple(tuple(l) for l in cfg["layers"])
    kernel = cfg.get("kernel", 2)
    dils = cfg.get("dilations", [1])
    return tuple((channels, channels, kernel, d) for d in dils)


def base_model_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    m = cfg.get("model", {}).get("base", {})
    signal_dim = m.get("signal_dim", 256)
    return {
        "signal_dim": signal_dim,
        "entry_kwidth": m.get("entry_kwidth", 2),
        "layers": layers_from_cfg(m, signal_dim),
        "out_dim": m.get("out_dim", signal_dim),
        "use_pallas": bool(m.get("use_pallas", False)),
        "remat": bool(m.get("remat", False)),
    }


def classifier_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    m = cfg.get("model", {}).get("classifier", {})
    signal_dim = cfg.get("model", {}).get("base", {}).get("signal_dim", 256)
    return {
        "num_labels": m.get("num_labels", 5),
        "layers": layers_from_cfg(m, signal_dim),
        "downsample": m.get("downsample", 1),
        "out_dim": m.get("out_dim", signal_dim),
        "in_dim": m.get("in_dim", signal_dim),
    }


def raw_ctcnet_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The "raw" model block with the JAX facade's defaults
    (facade.py:101-116, the reference's intended Model.py:41-53): 2048
    features, fk 3, 5 labels, dilations 1..64 x 20 cycles, kernel 3, out 512."""
    m = cfg.get("model", {}).get("raw", {})
    nfeats = m.get("num_features", 2048)
    kernel = m.get("kernel", 3)
    dils = tuple(m.get("dilations", [1, 2, 4, 8, 16, 32, 64]))
    layers = tuple((nfeats, nfeats, kernel, d) for d in dils) * m.get("num_dilation_blocks", 20)
    return {"num_features": nfeats, "feature_kwidth": m.get("feature_kwidth", 3),
            "num_labels": m.get("num_labels", 5), "layers": layers,
            "out_dim": m.get("out_dim", 512), "causal": bool(m.get("causal", False))}


def training_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The "training" block with the JAX package's defaults
    (utils/config.py:58-78)."""
    t = dict(cfg.get("training", {}))
    t.setdefault("batch_size", 8)
    t.setdefault("num_epochs", 1)
    t.setdefault("max_iters", 1000)
    t.setdefault("epoch_size", 1000)
    t.setdefault("nworkers", 1)
    t.setdefault("min_sample_length", 90)
    t.setdefault("max_sample_length", 100)
    t.setdefault("print_every", 25)
    t.setdefault("save_every", 1000)
    t.setdefault("save_dir", "./runs/run/")
    t.setdefault("training_data", None)
    t.setdefault("validation_data", None)
    t.setdefault("restore", None)
    opt = t.setdefault("optim", {})
    opt.setdefault("type", "adam")
    opt.setdefault("learning_rate", 1e-4)
    opt.setdefault("wd", 0.0)
    opt.setdefault("max_grad_norm", None)
    return t
