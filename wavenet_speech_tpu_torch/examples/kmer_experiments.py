"""The reference's three kmer research experiments (examples/
kmer_experiments.py; reference tests/kmer_mapping.py,
tests/kmer_stay_prediction.py, tests/decode_nucleotides_from_kmer.py) on
the port: eager PyTorch training loops with optax's Adamax
(``training.optimizer.build_optimizer("adamax", lr)``; torch.optim.Adamax
adds eps inside the max where optax adds it to the denominator, another
update).

  mapping   — can a pointwise MLP recover the 5-mer identity from a single
              Gaussian current sample?  (Reference result: no — it "fails to
              reproduce the kmer model after 2M loops", kmer_mapping.py:1-7;
              temporal context is essential.)
  stay      — predict per-frame kmer-or-STAY labels from raw signal with a
              RawCTCNet under frame-aligned cross entropy. (The reference
              script is an unfinished skeleton — its generator `fetch()` is
              `pass`, kmer_stay_prediction.py:37-39 — this implements the
              documented intent.)
  decode    — ByteNetDecoder decodes the nucleotide sequence from embedded
              5-mer encodings, teacher-forced next-nt cross entropy.
              (Reference result: learns "extremely quickly",
              decode_nucleotides_from_kmer.py:4-5.)

Usage:
  python -m wavenet_speech_tpu_torch.examples.kmer_experiments {mapping,stay,decode}
      [--steps N] [--device cpu]

It runs on ``cuda`` unless ``--device`` names another device. The batches
are numpy, drawn from ``np.random.default_rng(seed)`` in the JAX example's
order, so both see the same data. The initial parameters are drawn on the
CPU from a ``torch.Generator`` seeded by ``seed`` (``_mapping_init``,
``_stay_init``, ``_decode_init``) and then moved to the device, so the card
and the CPU start from the same parameters. No loop runs a kernel of the
port's own: the MLP is matmuls, RawCTCNet's blocks here are non-causal
(cuDNN), and ByteNet's blocks are convs and products.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from wavenet_speech_tpu_torch.data.gaussian_kmer import DEFAULT_KMER_MODEL, kmer_ids
from wavenet_speech_tpu_torch.models import ByteNetDecoder, RawCTCNet
from wavenet_speech_tpu_torch.training.optimizer import apply_updates, build_optimizer
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# the mapping MLP's LeakyReLU negative slope: nn.init.calculate_gain('leaky_relu')
MAPPING_SLOPE = float(np.sqrt(2.0 / (1 + 0.01 ** 2)))


def _kmer_tables():
    npz = np.load(DEFAULT_KMER_MODEL)
    return npz["means"].astype(np.float32), npz["stdvs"].astype(np.float32)


def _nts_to_kmers(nts: np.ndarray) -> np.ndarray:
    """Sliding 5-mer ids per batch row, the reference's base-4 positional
    encoding (decode_nucleotides_from_kmer.py:41-44) via the canonical
    kmer_ids helper (data/gaussian_kmer.py)."""
    return np.stack([kmer_ids(row, trim=0) for row in nts])


def _adamax_loop(params, lr: float, steps: int, next_batch: Callable, loss_fn: Callable,
                 report: Callable, callback: Optional[Callable]):
    """``steps`` Adamax steps of loss_fn(params, *next_batch()); report(k,
    loss) prints, callback(k, loss) (loss a 0-d tensor, not read back)
    sees every step. Returns (params, the last step's loss)."""
    tx = build_optimizer("adamax", lr)
    opt_state = tx.init(params)
    loss = None
    for k in range(steps):
        batch = next_batch()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        loss = loss_fn(params, *batch)
        grads = tree_unflatten(params, list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        loss = loss.detach()
        if callback:
            callback(k, loss)
        report(k, loss)
    return params, loss


def _mapping_init(dims, seed: int):
    """The MLP's layers [{"w": (d_i, d_i+1), "b"}] on the CPU: torch's
    nn.init.sparse as JAX's example draws it, normal(0, 0.01) zeroed where a
    uniform draw is below 0.1; biases 1e-4."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for i in range(len(dims) - 1):
        shape = (dims[i], dims[i + 1])
        w = torch.randn(shape, generator=gen) * 0.01
        keep = torch.rand(shape, generator=gen) >= 0.1
        params.append({"w": w * keep, "b": torch.full((dims[i + 1],), 1e-4)})
    return params


def _mlp(params, x):
    h = x @ params[0]["w"] + params[0]["b"]
    for lyr in params[1:-1]:
        h = F.leaky_relu(h @ lyr["w"] + lyr["b"], negative_slope=MAPPING_SLOPE)
    return h @ params[-1]["w"] + params[-1]["b"]


def run_mapping(steps: int, batch_size: int, nhid: int, lr: float, seed: int,
                device=None, callback: Optional[Callable] = None):
    """reference tests/kmer_mapping.py: Linear(1,1) -> 6x[Linear+LeakyReLU]
    -> Linear(nhid, 1024), CE against the kmer id, Adamax.

    Faithful quirks: the LeakyReLU negative slope is
    nn.init.calculate_gain('leaky_relu') ~= 1.4139 (kmer_mapping.py:39-51 —
    a near-linear activation), and weights use sparse init (sparsity 0.1,
    kmer_mapping.py:52). Honest divergence: the reference loop never calls
    loss.backward() (kmer_mapping.py:66-71), so its documented negative
    result came from an UNTRAINED model; this port actually trains, and one
    sample still cannot name the 5-mer: the CE falls only part of the way
    from chance (ln 1024) towards 0, since a current level narrows the
    1024 k-mers to the many whose Gaussians overlap there. Returns the last
    step's CE."""
    dev = resolve_device(device)
    means, stdvs = _kmer_tables()
    rng = np.random.default_rng(seed)
    dims = [1, 1] + [nhid] * 6 + [1024]
    params = tree_map(lambda t: t.to(dev), _mapping_init(dims, seed))

    def next_batch():
        kmers = rng.integers(0, 1024, size=batch_size)
        samples = rng.normal(means[kmers], stdvs[kmers])[:, None].astype(np.float32)
        return torch.from_numpy(samples).to(dev), torch.from_numpy(kmers).to(dev)

    def report(k, loss):
        if k % 100 == 0:
            print(f"step {k} | CE {float(loss):.4f} "
                  f"(chance {np.log(1024):.4f})", flush=True)

    _, loss = _adamax_loop(params, lr, steps, next_batch,
                           lambda p, x, y: F.cross_entropy(_mlp(p, x), y), report, callback)
    print(f"final CE {float(loss):.4f} vs chance {np.log(1024):.4f} — the "
          "reference documents this experiment as a negative result")
    return float(loss)


def _stay_batch(rng, means, stdvs, batch_size, num_kmers, shape, rate,
                max_dur, pad_frames):
    """Random 5-mer runs with Gamma durations -> (signal (B,L,1),
    frame labels (B,L) where frame 0 of each run is the kmer id and
    subsequent frames are STAY=1024)."""
    B = batch_size
    kmers = rng.integers(0, 1024, size=(B, num_kmers))
    durs = np.clip(np.ceil(rng.gamma(shape, 1.0 / rate, size=(B, num_kmers))
                           ).astype(int), 1, max_dur)
    L = pad_frames
    sig = np.zeros((B, L, 1), np.float32)
    lab = np.full((B, L), 1024, np.int64)  # STAY everywhere by default
    valid = np.zeros((B, L), bool)  # true frames (not tail padding)
    for b in range(B):
        t = 0
        for i in range(num_kmers):
            d = min(int(durs[b, i]), L - t)
            if d <= 0:
                break
            k = int(kmers[b, i])
            sig[b, t : t + d, 0] = rng.normal(means[k], stdvs[k], size=d)
            lab[b, t] = k
            t += d
        valid[b, :t] = True
    return sig, lab, valid


def _stay_init(net: RawCTCNet, seed: int):
    """RawCTCNet's initial state dict, drawn on the CPU from ``seed`` and
    copied onto the net's device."""
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def run_stay(steps: int, batch_size: int, num_features: int, lr: float,
             seed: int, device=None, callback: Optional[Callable] = None):
    """reference tests/kmer_stay_prediction.py intent: RawCTCNet over raw
    signal, 1025 labels (1024 kmers + STAY), frame-aligned CE over the real
    frames. Returns the last step's frame CE."""
    dev = resolve_device(device)
    means, stdvs = _kmer_tables()
    rng = np.random.default_rng(seed)
    num_kmers, shape, rate, max_dur = 20, 2.0, 0.5, 8
    pad_frames = num_kmers * max_dur

    layers = tuple((num_features, num_features, 2, d)
                   for d in (1, 2, 4, 8, 16)) * 2
    net = RawCTCNet(num_features, 3, 1025, layers, num_features,
                    positions=True, softmax=False, causal=False, device=dev)
    params = _stay_init(net, seed)

    def next_batch():
        sig, lab, valid = _stay_batch(rng, means, stdvs, batch_size, num_kmers, shape,
                                      rate, max_dur, pad_frames)
        return tuple(torch.from_numpy(a).to(dev) for a in (sig, lab, valid))

    def loss_fn(p, sig, lab, valid):
        logits = functional_call(net, p, (sig,))[:, : lab.shape[1]]
        ce = F.cross_entropy(logits.transpose(1, 2), lab, reduction="none")
        # mask the zero-signal tail padding so the metric measures
        # kmer-vs-STAY prediction on real frames only
        return (ce * valid).sum() / torch.clamp(valid.sum(), min=1)

    def report(k, loss):
        if k % 20 == 0:
            print(f"step {k} | frame CE {float(loss):.4f} "
                  f"(chance {np.log(1025):.4f})", flush=True)

    _, loss = _adamax_loop(params, lr, steps, next_batch, loss_fn, report, callback)
    print(f"final frame CE {float(loss):.4f}")
    return float(loss)


def _decode_init(dec: ByteNetDecoder, seed: int, enc_dim: int):
    """(the decoder's initial state dict, the frozen (1024, enc_dim)
    normal(1) k-mer embedding), drawn on the CPU from ``seed`` in that
    order and copied onto the decoder's device."""
    gen = torch.Generator().manual_seed(seed)
    dec.reset_parameters(gen)
    embed = torch.randn((1024, enc_dim), generator=gen)
    params = {k: v.detach().clone() for k, v in dec.state_dict().items()}
    return params, embed.to(next(dec.parameters()).device)


def run_decode(steps: int, batch_size: int, nt_length: int, channels: int,
               enc_dim: int, lr: float, seed: int, device=None,
               callback: Optional[Callable] = None):
    """reference tests/decode_nucleotides_from_kmer.py main_ce: embed the
    5-mer sequence, ByteNetDecoder predicts the next nucleotide, CE.
    Returns the last step's next-nt CE."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dec = ByteNetDecoder(num_labels=5, encoding_dim=enc_dim,
                         channels=channels, output_dim=2 * channels,
                         layers=((3, 1), (3, 2), (3, 4), (3, 8), (3, 16)),
                         block="mult", device=dev)
    # the reference optimizes decoder.parameters() only — its
    # nn.Embedding(1024, enc_dim) stays frozen at random init
    # (decode_nucleotides_from_kmer.py:70,76)
    params, kmer_embed = _decode_init(dec, seed, enc_dim)

    def next_batch():
        nts = rng.integers(1, 5, size=(batch_size, nt_length))
        kmers = _nts_to_kmers(nts)
        return torch.from_numpy(nts).to(dev), torch.from_numpy(kmers).to(dev)

    def loss_fn(p, nts, kmers):
        enc = kmer_embed[kmers]                      # (B, L_enc, enc_dim)
        L = enc.shape[1]
        logits = functional_call(dec, p, (nts[:, :L], enc))
        # next-timestep prediction (reference loss vs nt_var[:, t+1])
        return F.cross_entropy(logits.transpose(1, 2), nts[:, 1: L + 1])

    def report(k, loss):
        if k % 20 == 0:
            print(f"step {k} | next-nt CE {float(loss):.4f} "
                  f"(chance {np.log(4):.4f})", flush=True)

    _, loss = _adamax_loop(params, lr, steps, next_batch, loss_fn, report, callback)
    print(f"final next-nt CE {float(loss):.4f} — the reference documents "
          "this decoding as learning 'extremely quickly'")
    return float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("experiment", choices=("mapping", "stay", "decode"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default cuda)")
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.experiment == "mapping":
        out = run_mapping(args.steps or 2000, args.batch_size, nhid=512,
                          lr=args.lr, seed=args.seed, device=args.device)
    elif args.experiment == "stay":
        out = run_stay(args.steps or 300, args.batch_size, num_features=128,
                       lr=args.lr / 2, seed=args.seed, device=args.device)
    else:
        out = run_decode(args.steps or 300, args.batch_size, nt_length=100,
                         channels=128, enc_dim=256, lr=args.lr,
                         seed=args.seed, device=args.device)
    print(f"({time.time() - t0:.0f}s)")
    return out


if __name__ == "__main__":
    main()
