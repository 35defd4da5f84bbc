"""DBoW2-compatible binary vocabulary: parse, train, batched transform.

Replaces the vendored DBoW2 TemplatedVocabulary (Thirdparty/DBoW2 —
SURVEY.md §2.2): the k^L hierarchical binary vocabulary becomes packed
arrays, and the per-descriptor tree descent becomes a batched L-level
Hamming argmin over each node's children (one [D, k] distance matrix
per level — a matmul), exactly the "10-way compare per level" redesign
the survey prescribes.

Because the reference's ORBvoc.txt (145 MB) is not shippable here, the
vocabulary can also be TRAINED from descriptors with hierarchical
k-majority (binary k-means), which is DBoW2's own construction; the
text format parser accepts the original file when present.

Scoring: L1 (DBoW2 default for ORB vocabularies) on tf-idf weighted,
L1-normalized sparse BoW vectors: s = 2 * sum_i min(a_i, b_i) computed
over the sparse intersection.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hamming import hamming_matrix


class Vocabulary:
    """Packed hierarchical binary vocabulary.

    Arrays:
      children: int32 [n_nodes, k] child node ids (-1 padding)
      node_desc: uint8 [n_nodes, 32]
      word_id: int32 [n_nodes] leaf word index (-1 for internal)
      word_weight: float32 [n_words] idf weights
      word_node: int32 [n_words] node id of each word (for direct index)
    """

    def __init__(self, children, node_desc, word_id, word_weight, k, depth):
        self.children = np.asarray(children, np.int32)
        self.node_desc = np.asarray(node_desc, np.uint8)
        self.word_id = np.asarray(word_id, np.int32)
        self.word_weight = np.asarray(word_weight, np.float32)
        self.k = int(k)
        self.depth = int(depth)
        self.n_words = len(word_weight)
        self._jit_transform = None

    # ------------------------------------------------------------------
    @staticmethod
    def train(descriptors: np.ndarray, k: int = 8, depth: int = 4, seed: int = 0):
        """Hierarchical k-majority clustering of packed descriptors."""
        rng = np.random.default_rng(seed)
        bits_all = np.unpackbits(np.asarray(descriptors, np.uint8), axis=1)  # [N,256]

        children_list = [[]]  # node 0 = root
        desc_list = [np.zeros(32, np.uint8)]
        word_of_node = {}

        def kmajority(bits, n_clusters, iters=8):
            n = len(bits)
            if n <= n_clusters:
                return np.arange(n) % max(n_clusters, 1), bits[
                    np.arange(n_clusters) % max(n, 1)
                ]
            centers = bits[rng.choice(n, n_clusters, replace=False)]
            for _ in range(iters):
                d = (bits[:, None, :] != centers[None, :, :]).sum(-1)
                assign = d.argmin(1)
                for c in range(n_clusters):
                    sel = bits[assign == c]
                    if len(sel):
                        centers[c] = (sel.mean(0) > 0.5).astype(np.uint8)
                    else:
                        centers[c] = bits[rng.integers(n)]
            d = (bits[:, None, :] != centers[None, :, :]).sum(-1)
            return d.argmin(1), centers

        def build(node, bits, level):
            if level == depth or len(bits) <= 1:
                word_of_node[node] = True
                return
            n_c = min(k, max(1, len(bits)))
            assign, centers = kmajority(bits, n_c)
            for c in range(n_c):
                child = len(children_list)
                children_list.append([])
                desc_list.append(np.packbits(centers[c]))
                children_list[node].append(child)
                build(child, bits[assign == c], level + 1)

        # subsample for tractability
        if len(bits_all) > 20000:
            bits_all = bits_all[rng.choice(len(bits_all), 20000, replace=False)]
        build(0, bits_all, 0)

        n_nodes = len(children_list)
        children = np.full((n_nodes, k), -1, np.int32)
        for i, ch in enumerate(children_list):
            children[i, : len(ch)] = ch
        node_desc = np.stack(desc_list)
        word_id = np.full(n_nodes, -1, np.int32)
        leaves = sorted(word_of_node.keys())
        for w, node in enumerate(leaves):
            word_id[node] = w
        # idf weights: uniform at training time (DBoW2 computes idf from
        # the training corpus; uniform keeps scores comparable).
        word_weight = np.ones(len(leaves), np.float32)
        return Vocabulary(children, node_desc, word_id, word_weight, k, depth)

    # ------------------------------------------------------------------
    @staticmethod
    def synthesize(k: int = 10, depth: int = 5, seed: int = 0):
        """Synthesize a full k^depth-leaf vocabulary with random node
        descriptors (k=10, depth=5 -> 10^5 words; depth=6 matches the
        reference's ~10^6-leaf ORBvoc.txt scale).  Training k-majority
        at that scale needs a corpus this environment can't ship; a
        random tree exercises the same transform/index/scoring paths at
        the same shapes (VERDICT r3 'next round' #8).  Vectorized
        level-order construction — no Python recursion."""
        rng = np.random.default_rng(seed)
        level_sizes = [k**lvl for lvl in range(depth + 1)]
        n_nodes = sum(level_sizes)
        starts = np.cumsum([0] + level_sizes)
        children = np.full((n_nodes, k), -1, np.int32)
        for lvl in range(depth):
            parents = np.arange(starts[lvl], starts[lvl + 1])
            base = starts[lvl + 1] + (parents - starts[lvl]) * k
            children[parents] = base[:, None] + np.arange(k)[None, :]
        node_desc = rng.integers(0, 256, (n_nodes, 32), dtype=np.uint8)
        word_id = np.full(n_nodes, -1, np.int32)
        leaves = np.arange(starts[depth], starts[depth + 1])
        word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
        word_weight = np.ones(len(leaves), np.float32)
        return Vocabulary(children, node_desc, word_id, word_weight, k, depth)

    def save_orbvoc_txt(self, path: str | Path) -> None:
        """Serialize in DBoW2's ORBvoc.txt node-list format (header
        'k L scoring weighting'; one line per non-root node:
        parent_id is_leaf d0..d31 weight) — round-trips through
        parse_orbvoc_txt (both the native mmap parser and the Python
        fallback), and is what lets the suite exercise the parser
        without the 145 MB reference file."""
        n = self.children.shape[0]
        parents = np.full(n, -1, np.int64)
        ch = self.children
        rows = np.repeat(np.arange(n), ch.shape[1])
        flat = ch.ravel()
        sel = flat >= 0
        parents[flat[sel]] = rows[sel]
        # Vectorized serialization: one float64 matrix -> one savetxt
        # pass (a per-node Python format loop takes minutes at the
        # reference scale of ~1.1M nodes / 145 MB; all values are
        # integers < 2^53, exact in float64).
        wid = self.word_id
        is_leaf = wid[1:] >= 0
        wgt = np.zeros(n - 1, np.float64)
        wgt[is_leaf] = self.word_weight[wid[1:][is_leaf]]
        body = np.empty((n - 1, 35), np.float64)
        body[:, 0] = parents[1:]
        body[:, 1] = is_leaf
        body[:, 2:34] = self.node_desc[1:]
        body[:, 34] = wgt
        with open(path, "w") as f:
            f.write(f"{self.k} {self.depth} 0 0\n")
            np.savetxt(f, body, fmt=" ".join(["%d"] * 34 + ["%g"]))

    @staticmethod
    def parse_orbvoc_txt(path: str | Path):
        """Parse DBoW2's text vocabulary format (ORBvoc.txt):
        header 'k L scoring weighting', then one node per line:
        parent_id is_leaf 32-byte-descriptor weight.

        Uses the native mmap parser (native/vocab_parser.cpp via
        ctypes) when available — the 145 MB reference vocabulary parses
        in seconds instead of minutes — with a pure-Python fallback."""
        from ..utils.native import parse_orbvoc_native

        parsed = parse_orbvoc_native(path)
        if parsed is not None:
            k, depth, parents, leafs, descs, weights = parsed
        else:
            with open(path) as f:
                header = f.readline().split()
                k, depth = int(header[0]), int(header[1])
                parents, leafs, descs, weights = [], [], [], []
                for line in f:
                    parts = line.split()
                    if len(parts) < 35:
                        continue
                    parents.append(int(parts[0]))
                    leafs.append(int(parts[1]))
                    descs.append([int(x) for x in parts[2:34]])
                    weights.append(float(parts[34]))
            parents = np.asarray(parents, np.int32)
            leafs = np.asarray(leafs, np.int32)
            descs = np.asarray(descs, np.uint8)
            weights = np.asarray(weights, np.float64)
        return Vocabulary._from_node_list(k, depth, parents, leafs, descs, weights)

    @staticmethod
    def _from_node_list(k, depth, parents, leafs, descs, weights):
        n = len(parents) + 1  # + root (node 0)
        children = np.full((n, k), -1, np.int32)
        counts = np.zeros(n, np.int32)
        node_desc = np.zeros((n, 32), np.uint8)
        word_id = np.full(n, -1, np.int32)
        w = 0
        weights_out = []
        for i in range(len(parents)):
            node = i + 1
            p = int(parents[i])
            children[p, counts[p] % k] = node
            counts[p] += 1
            node_desc[node] = descs[i]
            if leafs[i]:
                word_id[node] = w
                weights_out.append(float(weights[i]))
                w += 1
        return Vocabulary(children, node_desc, word_id,
                          np.asarray(weights_out, np.float32), k, depth)

    # ------------------------------------------------------------------
    def transform_words(self, descs: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Map each descriptor to its leaf word id (-1 for invalid).

        Batched device descent: at each level one [D, k] Hamming matrix
        against the current nodes' children.
        """
        if self._jit_transform is None:
            children = jnp.asarray(self.children)
            node_desc = jnp.asarray(self.node_desc)
            word_id = jnp.asarray(self.word_id)
            k = self.k

            @jax.jit
            def descend(d):
                D = d.shape[0]
                node = jnp.zeros(D, jnp.int32)

                def level(_, node):
                    ch = children[node]                      # [D, k]
                    ch_desc = node_desc[jnp.clip(ch, 0, None)]  # [D, k, 32]
                    x = jnp.bitwise_xor(ch_desc, d[:, None, :])
                    dist = jnp.sum(
                        jax.lax.population_count(x).astype(jnp.int32), axis=-1
                    )
                    dist = jnp.where(ch >= 0, dist, 1 << 16)
                    nxt = jnp.take_along_axis(
                        ch, jnp.argmin(dist, axis=1)[:, None], axis=1
                    )[:, 0]
                    # dead-end guard: stay put if no children
                    return jnp.where(nxt >= 0, nxt, node)

                node = jax.lax.fori_loop(0, self.depth, level, node)
                return word_id[node]

            self._jit_transform = descend
        words = np.asarray(self._jit_transform(jnp.asarray(descs)))
        return np.where(np.asarray(valid), words, -1)

    def dispatch_transform(self, descs):
        """Dispatch the device word descent WITHOUT fetching: the caller
        resolves the returned device array later (LoopCloser hides the
        device fetch behind one keyframe interval)."""
        if self._jit_transform is None:
            self.transform_words(descs[:1], np.ones(1, bool))  # build jit
        out = self._jit_transform(jnp.asarray(descs))
        try:
            out.copy_to_host_async()
        except AttributeError:
            pass
        return out

    @staticmethod
    def bow_from_words(words: np.ndarray, valid: np.ndarray,
                       word_weight: np.ndarray):
        """(sorted word ids, L1-normalized tf-idf weights) from resolved
        leaf words (the host half of bow_vector)."""
        words = np.where(valid, words, -1)
        words = words[words >= 0]
        if len(words) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        ids, counts = np.unique(words, return_counts=True)
        w = counts.astype(np.float32) * word_weight[ids]
        n = w.sum()
        if n > 0:
            w = w / n
        return ids.astype(np.int32), w

    def bow_vector(self, descs, valid):
        """Sparse tf-idf BoW: (sorted word ids [W], L1-normalized weights)."""
        words = self.transform_words(descs, valid)
        words = words[words >= 0]
        if len(words) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        ids, counts = np.unique(words, return_counts=True)
        w = counts.astype(np.float32) * self.word_weight[ids]
        n = w.sum()
        if n > 0:
            w = w / n
        return ids.astype(np.int32), w

    @staticmethod
    def score_l1(ids_a, wa, ids_b, wb) -> float:
        """DBoW2 L1 score 1 - 0.5*|a-b|_1, which for L1-normalized
        vectors equals sum_i min(a_i, b_i) over shared words; 1.0 for
        identical vectors, 0.0 for disjoint."""
        if len(ids_b) == 0 or len(ids_a) == 0:
            return 0.0
        ia = np.searchsorted(ids_b, ids_a)
        ia = np.clip(ia, 0, len(ids_b) - 1)
        match = ids_b[ia] == ids_a
        return float(np.minimum(wa[match], wb[ia[match]]).sum())
