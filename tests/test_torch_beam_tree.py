"""A CPU model of the beam kernel's bookkeeping (csrc/ctc_beam.cu), held
frame by frame against the plain ``_beam_step`` on dense rows.

The kernel keeps hypotheses as nodes (parent, label, emission frame) in a
pool, not as (W, S) rows. ``TreeBeam`` below does what the kernel does with
them: the slots of a frame's new nodes (n_in + t * W + r), the top W taken
among the candidates not below the worst stay, the appends for
an extension and for a stay that adopts its dominant parent's times, the
exact parent test (the beams' prefix hashes reject, equal hashes are
confirmed by equal ids or by walking two chains up until the ids meet or
the labels differ), the rows written once at the end, and the trie the
kernel builds from an input state, with its hashes. Its scores are ``_beam_step``'s own arithmetic, so the
two runs select the same candidates and every row, live or dead, must be
equal at every frame: prefixes, lengths and times equal, pb and pnb equal
bit for bit.

The kernel's own arithmetic (its logaddexp and merge, in CUDA) is held
against the plain version on the card: tests/test_torch_kernels.py feeds it
the inputs pinned here (``PINNED_DUPLICATE``)."""
import numpy as np
import pytest
import torch

from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, _beam_step, _top_k_stable, beam_init, beam_scan)


def lp_numpy(B, T, C, seed=0, sharp=2.0, blank_frac=0.6):
    """Log-probs (B, T, C) float32 from a seed: random logits, blank
    boosted on a fraction of the frames, log-softmaxed with numpy."""
    rng = np.random.default_rng(seed)
    logits = (sharp * rng.standard_normal((B, T, C))).astype(np.float32)
    logits[:, rng.random(T) < blank_frac, 0] += sharp
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


# (B, T, C, seed), lengths, W, S, prune: inputs on which a parent test meets
# two different nodes that hold the same prefix (TreeBeam.dup_parents > 0)
PINNED_DUPLICATE = ((2, 120, 5, 11), [120, 95], 7, 64, None)
HASH_P, MASK32 = 0x9E3779B1, 0xFFFFFFFF  # csrc/ctc_beam.cu's prefix hash


def prefix_hash(labels):
    """sum_s (label_s + 1) * HASH_P^s mod 2^32."""
    return sum((int(c) + 1) * pow(HASH_P, s, 1 << 32) for s, c in enumerate(labels)) & MASK32


class TreeBeam:
    """The kernel's node pool and beams for a batch, on the CPU."""

    def __init__(self, B, W, S, cap, state=None):
        self.B, self.W, self.S = B, W, S
        self.par = np.full((B, cap), -1, np.int64)
        self.lab = np.full((B, cap), -1, np.int64)
        self.tim = np.zeros((B, cap), np.int64)
        self.node = np.zeros((B, W), np.int64)
        self.pnode = np.full((B, W), -1, np.int64)
        # each beam's prefix hash, its parent's, and HASH_P^plen
        self.h = np.zeros((B, W), np.int64)
        self.ph = np.zeros((B, W), np.int64)
        self.pw = np.ones((B, W), np.int64)
        self.walk_steps = []     # chain-walk steps of each parent test
        self.dup_parents = 0     # parents found with different ids
        self.hash_misses = 0     # equal hashes, other prefixes
        if state is None:
            init = beam_init(B, W, S)
            self.plens, self.pb, self.pnb = init[1].clone(), init[2], init[3]
            self.n_in = 1
        else:
            self.plens, self.pb, self.pnb = state[1].clone(), state[2], state[3]
            self.n_in = max(self._build_trie(b, state[0][b].numpy(), state[4][b].numpy())
                            for b in range(B))
            for b in range(B):
                for r in range(W):
                    n = int(self.plens[b, r])
                    self.h[b, r] = prefix_hash(state[0][b, r, :n])
                    self.ph[b, r] = prefix_hash(state[0][b, r, :max(n - 1, 0)])
                    self.pw[b, r] = pow(HASH_P, n, 1 << 32)

    def _build_trie(self, b, pref, times):
        """The input rows as a trie over (label, time): row r shares its
        longest common prefix with the first earlier row that has it."""
        W, plen = self.W, self.plens[b].tolist()
        best, lcp, base = [-1] * W, [0] * W, [0] * (W + 1)
        for r in range(W):
            for q in range(r):
                n = min(plen[r], plen[q])
                if n <= lcp[r]:
                    continue
                ne = (pref[q, :n] != pref[r, :n]) | (times[q, :n] != times[r, :n])
                l = int(np.argmax(ne)) if ne.any() else n
                if l > lcp[r]:
                    lcp[r], best[r] = l, q
        base[0] = 1
        for r in range(W):
            base[r + 1] = base[r] + plen[r] - lcp[r]

        def node_at(q, s):
            while s < lcp[q]:
                q = best[q]
            return base[q] + s - lcp[q]

        for r in range(W):
            for s in range(lcp[r], plen[r]):
                i = base[r] + s - lcp[r]
                self.par[b, i] = i - 1 if s > lcp[r] else (0 if s == 0 else node_at(best[r], s - 1))
                self.lab[b, i], self.tim[b, i] = pref[r, s], times[r, s]
            n = plen[r]
            self.node[b, r] = node_at(r, n - 1) if n > 0 else 0
            self.pnode[b, r] = node_at(r, n - 2) if n > 1 else n - 1
        return base[W]

    def _is_parent(self, b, v, w):
        """v is w's parent (lengths already checked): a different hash
        rejects; else walk parent(node_w) and node_v up until the ids meet
        or the labels differ."""
        if self.h[b, v] != self.ph[b, w]:
            return False
        x, y, steps = self.pnode[b, w], self.node[b, v], 0
        first_equal = x == y
        while x != y and self.lab[b, x] == self.lab[b, y]:
            x, y, steps = self.par[b, x], self.par[b, y], steps + 1
        self.walk_steps.append(steps)
        if x == y and not first_equal:
            self.dup_parents += 1
        self.hash_misses += x != y
        return bool(x == y)

    def last(self):
        lab = np.take_along_axis(self.lab, self.node, 1)
        return torch.from_numpy(np.where(self.plens.numpy() > 0, lab, -1))

    def step(self, lp, t, tg, *, blank, prune=None):
        """Frame t of this call (global index tg): _beam_step's scores, the
        kernel's bookkeeping."""
        B, W, S = self.B, self.W, self.S
        C = lp.shape[-1]
        plens, pb, pnb = self.plens, self.pb, self.pnb
        neg = torch.tensor(NEG_INF)
        total = torch.logaddexp(pb, pnb)
        alive = total > NEG_INF / 2
        last = self.last()
        lp_last = torch.where(last >= 0, lp.gather(1, last.clamp(min=0)), neg)
        stay_pb = total + lp[:, blank:blank + 1]
        stay_pnb = pnb + lp_last
        if prune is not None and prune < C:
            lp_cand, labels = _top_k_stable(lp, prune)
        else:
            labels, lp_cand = torch.arange(C).expand(B, C), lp
        K = labels.shape[1]
        same = labels[:, None, :] == last[:, :, None]
        ext_pnb = torch.where(same, pb[:, :, None], total[:, :, None]) + lp_cand[:, None, :]
        can_extend = (labels[:, None, :] != blank) & (plens[:, :, None] < S)
        ext_pnb = torch.where(can_extend, ext_pnb, neg)
        # the parent test, run where the kernel runs it: w alive and last_w
        # among the frame's candidate labels
        is_parent = torch.zeros((B, W, W), dtype=torch.bool)
        has_slot = same.any(-1)
        for b in range(B):
            for w in range(W):
                if not (alive[b, w] and has_slot[b, w]):
                    continue
                for v in range(W):
                    if plens[b, v] + 1 == plens[b, w]:
                        is_parent[b, v, w] = self._is_parent(b, v, w)
        ext_at_cw = torch.where(same[:, None, :, :], ext_pnb[:, :, None, :], neg).amax(-1)
        contrib = torch.where(is_parent, ext_at_cw, neg)
        contrib_mass = torch.logsumexp(contrib, dim=1)
        vstar = contrib.argmax(dim=1)
        adopt = contrib_mass > torch.logaddexp(stay_pb, stay_pnb)
        stay_pnb = torch.logaddexp(stay_pnb, contrib_mass)
        consumed = (is_parent[:, :, :, None] & same[:, None, :, :]).any(2)
        ext_pnb = torch.where(consumed, neg, ext_pnb)
        cand = torch.cat([torch.logaddexp(stay_pb, stay_pnb),
                          torch.logaddexp(neg, ext_pnb).reshape(B, W * K)], 1)
        _, sel = _top_k_stable(cand, W)
        # the kernel ranks only the candidates not below the worst stay
        tau = cand[:, :W].min(1, keepdim=True).values
        for b in range(B):
            keep = torch.nonzero(cand[b] >= tau[b]).flatten()
            assert torch.equal(keep[_top_k_stable(cand[b, keep], W)[1]], sel[b])
        # the rows of the next beam as nodes: kept, or appended at slot r
        node, pnode = self.node.copy(), self.pnode.copy()
        h, ph, pw = self.h.copy(), self.ph.copy(), self.pw.copy()
        new_plens = torch.empty_like(plens)
        for b in range(B):
            for r in range(W):
                i, slot = int(sel[b, r]), self.n_in + t * W + r
                if i < W:
                    new_plens[b, r] = plens[b, i]
                    h[b, r], ph[b, r], pw[b, r] = self.h[b, i], self.ph[b, i], self.pw[b, i]
                    if adopt[b, i]:  # the dominant parent's times, tg at the end
                        a = self.node[b, int(vstar[b, i])]
                        self._append(b, slot, a, int(last[b, i]), tg)
                        node[b, r], pnode[b, r] = slot, a
                    else:
                        node[b, r], pnode[b, r] = self.node[b, i], self.pnode[b, i]
                    continue
                v, k = divmod(i - W, K)
                h[b, r], ph[b, r], pw[b, r] = self.h[b, v], self.ph[b, v], self.pw[b, v]
                if plens[b, v] < S:
                    lab = int(labels[b, k])
                    self._append(b, slot, self.node[b, v], lab, tg)
                    node[b, r], pnode[b, r] = slot, self.node[b, v]
                    new_plens[b, r] = plens[b, v] + 1
                    ph[b, r] = self.h[b, v]
                    h[b, r] = (int(self.h[b, v]) + (lab + 1) * int(self.pw[b, v])) & MASK32
                    pw[b, r] = int(self.pw[b, v]) * HASH_P & MASK32
                else:  # no room: the source's prefix and times
                    node[b, r], pnode[b, r] = self.node[b, v], self.pnode[b, v]
                    new_plens[b, r] = S
        is_stay = sel < W
        e = (sel - W).clamp(min=0)
        src = torch.where(is_stay, sel, e // K)
        self.pb = torch.where(is_stay, stay_pb.gather(1, src), neg)
        self.pnb = torch.where(is_stay, stay_pnb.gather(1, src),
                               ext_pnb.reshape(B, W * K).gather(1, e))
        self.node, self.pnode, self.plens = node, pnode, new_plens
        self.h, self.ph, self.pw = h, ph, pw

    def _append(self, b, slot, parent, label, frame):
        assert self.lab[b, slot] == -1, "a node slot written twice"
        self.par[b, slot], self.lab[b, slot], self.tim[b, slot] = parent, label, frame

    def check_hashes(self):
        """Each beam's carried hashes are its prefix's."""
        pref, plens = self.rows()[:2]
        for b in range(self.B):
            for r in range(self.W):
                n = int(plens[b, r])
                assert self.h[b, r] == prefix_hash(pref[b, r, :n])
                if n:
                    assert self.ph[b, r] == prefix_hash(pref[b, r, :n - 1])
                assert self.pw[b, r] == pow(HASH_P, n, 1 << 32)

    def rows(self):
        """The dense state: each beam's chain walked back to the root, zero
        past its length."""
        B, W, S = self.B, self.W, self.S
        pref = torch.zeros((B, W, S), dtype=torch.int32)
        times = torch.zeros((B, W, S), dtype=torch.int32)
        for b in range(B):
            for r in range(W):
                n = self.node[b, r]
                for s in range(int(self.plens[b, r]) - 1, -1, -1):
                    pref[b, r, s], times[b, r, s] = int(self.lab[b, n]), int(self.tim[b, n])
                    n = self.par[b, n]
                assert n == 0, "a chain longer than its length"
        return pref, self.plens.clone(), self.pb, self.pnb, times


def assert_states_equal(got, want, where):
    for name, g, w in zip(("prefixes", "plens", "pb", "pnb", "times"), got, want):
        assert torch.equal(g, w), f"{where}: {name} differ"


def run_tree(lp, lengths, W, S, prune, *, state=None, t0=0, check_every_frame=True):
    """TreeBeam over lp (B, T, C) from state at global frame t0, held
    against _beam_step on the dense rows. Returns (TreeBeam, dense state)."""
    lp = torch.from_numpy(lp) if isinstance(lp, np.ndarray) else lp
    B, T, _ = lp.shape
    lengths = torch.as_tensor(lengths)
    n_in = 1 if state is None else 1 + int(state[1].sum(1).max())
    tree = TreeBeam(B, W, S, n_in + W * T, state)
    dense = beam_init(B, W, S) if state is None else state
    if state is not None:
        assert_states_equal(tree.rows(), dense, "the input trie")
    for t in range(T):
        tg = t0 + t
        live = tg < lengths
        if not live.any():
            break
        # the kernel runs frames t < lengths[b] - t0 per sequence; a dead
        # sequence's beam is carried, as beam_scan carries it
        keep = (tree.node.copy(), tree.pnode.copy(), tree.plens, tree.pb, tree.pnb,
                tree.h, tree.ph, tree.pw)
        tree.step(lp[:, t], t, tg, blank=0, prune=prune)
        for b in np.flatnonzero(~live.numpy()):
            tree.node[b], tree.pnode[b] = keep[0][b], keep[1][b]
            tree.plens[b], tree.pb[b], tree.pnb[b] = keep[2][b], keep[3][b], keep[4][b]
            tree.h[b], tree.ph[b], tree.pw[b] = keep[5][b], keep[6][b], keep[7][b]
        new = _beam_step(dense, lp[:, t], tg, blank=0, prune=prune)
        dense = tuple(torch.where(live.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                      for n, o in zip(new, dense))
        if check_every_frame:
            assert_states_equal(tree.rows(), dense, f"frame {tg}")
            tree.check_hashes()
    assert_states_equal(tree.rows(), dense, "the end")
    return tree, dense


CASES = {  # (B, T, C, seed), lengths, W, S, prune
    "dna": ((2, 100, 5, 0), [100, 77], 7, 64, None),
    "speech_alphabet": ((2, 60, 30, 1), [60, 60], 8, 32, None),
    "pruned": ((1, 60, 30, 2), [60], 8, 32, 12),
    "times": ((1, 80, 5, 3), [80], 5, 48, None),
    "saturated_cap": ((2, 50, 5, 7), [50, 50], 7, 5, None),
    "width_1": ((2, 60, 5, 4), [60, 41], 1, 64, None),
    "width_32": ((1, 30, 5, 5), [30], 32, 32, None),
    "length_0": ((3, 40, 5, 6), [40, 0, 13], 7, 40, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_matches_dense_rows(case):
    shape, lengths, W, S, prune = CASES[case]
    tree, dense = run_tree(lp_numpy(*shape), lengths, W, S, prune)
    if case == "saturated_cap":
        assert int(dense[1].max()) == S
    if case == "length_0":  # the initial state, untouched
        assert_states_equal(tuple(x[1:2] for x in tree.rows()),
                            tuple(x[:1] for x in beam_init(1, W, S)), "length 0")


def test_tree_long_decode_walks_stay_short():
    """About 400 frames: the per-frame work stays O(W^2) parent tests, and
    each test's walk stays a few steps however long the prefixes grow."""
    tree, dense = run_tree(lp_numpy(2, 400, 5, 8), [400, 400], 7, 400, None,
                           check_every_frame=False)
    assert int(dense[1].max()) > 100
    assert max(tree.walk_steps) < 50, max(tree.walk_steps)


def test_tree_duplicate_nodes_are_parents():
    """Pinned inputs on which a parent and its child hold different nodes
    for the same prefix (a stay that adopted its parent's times is a new
    node while the old node's child lives on): an id test alone would miss
    the merge."""
    shape, lengths, W, S, prune = PINNED_DUPLICATE
    tree, _ = run_tree(lp_numpy(*shape), lengths, W, S, prune)
    assert tree.dup_parents > 0


def test_tree_duplicate_built_directly():
    """A state built by hand: row 1's prefix (1, 2) hangs off row 0's node
    of prefix (1,) through a second node of (1,) with other times, so row 0
    is row 1's parent with ids that differ from the first step."""
    W, S = 2, 4
    pref = torch.tensor([[[1, 0, 0, 0], [1, 2, 0, 0]]], dtype=torch.int32)
    times = torch.tensor([[[3, 0, 0, 0], [1, 2, 0, 0]]], dtype=torch.int32)
    state = (pref, torch.tensor([[1, 2]], dtype=torch.int32),
             torch.tensor([[-1.0, -1.5]]), torch.tensor([[-0.5, -0.7]]), times)
    lp = torch.log_softmax(torch.tensor([[[0.1, 0.5, 2.0]]]), -1)
    tree, _ = run_tree(lp, [5], W, S, None, state=state, t0=4)
    assert tree.dup_parents == 1


def test_tree_hash_collision_falls_back_to_the_walk():
    """Beams whose hashes are forced equal while their prefixes differ: the
    walk still finds no parent, and the decode stays exact."""
    shape, lengths, W, S, prune = CASES["dna"]
    lp = torch.from_numpy(lp_numpy(*shape))
    B, T, _ = lp.shape
    tree = TreeBeam(B, W, S, 1 + W * T)
    dense = beam_init(B, W, S)
    for t in range(T):
        tree.h[:], tree.ph[:] = 0, 0  # every hash equal: the walk decides
        tree.step(lp[:, t], t, t, blank=0)
        dense = _beam_step(dense, lp[:, t], t, blank=0)
    assert_states_equal(tree.rows(), dense, "the end")
    assert tree.hash_misses > 0


@pytest.mark.parametrize("case", ["dna", "pruned", "saturated_cap"])
def test_tree_chained_calls_build_the_trie(case):
    """Frames [0, t1) from the empty beam, then [t1, T) from the rows it
    returns, as the kernel's second call rebuilds them into a trie: equal
    to one dense decode."""
    (B, T, C, seed), lengths, W, S, prune = CASES[case]
    lp = lp_numpy(B, T, C, seed)
    t1 = T // 2
    _, mid = run_tree(lp[:, :t1], lengths, W, S, prune, check_every_frame=False)
    tree, got = run_tree(lp[:, t1:], lengths, W, S, prune, state=mid, t0=t1,
                         check_every_frame=False)
    want = beam_scan(beam_init(B, W, S), torch.from_numpy(lp), torch.tensor(lengths),
                     blank=0, prune=prune)
    assert_states_equal(got, want, "two calls against one")
    # the trie shares the rows' common prefixes: fewer nodes than labels
    assert tree.n_in < 1 + int(mid[1].sum(1).max())
