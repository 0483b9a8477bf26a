"""CSR-packed decoding graphs (verbatim twin of
``kaldi_cnn_tpu/decode/graph.py``, importable without jax).

The reference's decoders walk OpenFst arc iterators state-by-state
(ref: src/decoder/lattice-faster-decoder.cc ProcessEmitting).  For
vectorized (numpy host) and batched (device) token passing we pre-pack the
graph into flat arc arrays split by emitting (ilabel = transition-id >
0) vs epsilon arcs, with pdf-ids resolved per arc so the inner loop is
pure gathers.
"""

from __future__ import annotations

import numpy as np

from kaldi_cnn_tpu_torch.lang.fst import Fst


class CompiledGraph:
    def __init__(self, fst: Fst, trans_id_to_pdf: np.ndarray):
        self.num_states = fst.num_states
        self.start = fst.start
        e_src, e_dst, e_ilabel, e_olabel, e_w = [], [], [], [], []
        n_src, n_dst, n_olabel, n_w = [], [], [], []
        for s in range(fst.num_states):
            for a in fst.arcs[s]:
                if a.ilabel > 0:
                    e_src.append(s)
                    e_dst.append(a.nextstate)
                    e_ilabel.append(a.ilabel)
                    e_olabel.append(a.olabel)
                    e_w.append(a.weight)
                else:
                    n_src.append(s)
                    n_dst.append(a.nextstate)
                    n_olabel.append(a.olabel)
                    n_w.append(a.weight)
        self.e_src = np.asarray(e_src, np.int32)
        self.e_dst = np.asarray(e_dst, np.int32)
        self.e_ilabel = np.asarray(e_ilabel, np.int32)
        self.e_olabel = np.asarray(e_olabel, np.int32)
        self.e_weight = np.asarray(e_w, np.float32)
        self.e_pdf = trans_id_to_pdf[self.e_ilabel].astype(np.int32)
        self.n_src = np.asarray(n_src, np.int32)
        self.n_dst = np.asarray(n_dst, np.int32)
        self.n_olabel = np.asarray(n_olabel, np.int32)
        self.n_weight = np.asarray(n_w, np.float32)
        self.final = np.asarray(fst.final, np.float32)

    @property
    def num_emitting_arcs(self) -> int:
        return len(self.e_src)

    @property
    def num_eps_arcs(self) -> int:
        return len(self.n_src)
