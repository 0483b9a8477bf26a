#!/usr/bin/env python3
"""Every random draw that ``rm.run`` and ``wsj.run`` make, in both
packages, at the recipes' own shapes (the CPU; JAX on the CPU).

    JAX_PLATFORMS=cpu python3 scripts/draw_audit.py > scripts/draw_audit.jsonl

One JSON line a draw:

- ``dither``: the noise each package adds to the frames of a corpus
  (RM seed 29: MFCC, train / dev / test at seeds 29 / 30 / 31; WSJ seed
  37: MFCC and the fbank volumes).  Both extractors run as the recipes
  run them (``extract_corpus``, its per-utterance key or generator) on
  zero waves of the corpus's lengths with DC removal, pre-emphasis and
  the window turned off, so what comes out is the noise itself.
- ``init``: ``Nnet.init`` at the RM p-norm DNN's and the WSJ CNN's
  shapes, from the trainer's (seed, "init"), component by component.
- ``gmm_split``: ``DiagGmm.split`` and ``AmDiagGmm.split`` (mixing up)
  with the trainers' ``np.random.default_rng(seed)``.
- ``egs_shuffle``: ``make_cnn_egs``' permutation and ``EgsBatcher``'s
  epoch orders.
- ``streams``: the per-stage seed derivation: the correlation between
  the noise of every pair of sets (train / dev / test) and utterances,
  and whether two utterances share a stream.

Each line gives, for each package, the shape, the number of elements
drawn, the mean and the standard deviation, and the two-sample KS
statistic and p between the packages (numpy draws: whether they are
bit-equal).  Dropout draws nothing in these recipes (neither net has a
Dropout component).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
from scipy import stats  # noqa: E402

from kaldi_cnn_tpu.core.rng import stage_key  # noqa: E402
from kaldi_cnn_tpu.features import functional as JF  # noqa: E402
from kaldi_cnn_tpu.features.extractor import (  # noqa: E402
    FeatureExtractor as JExtractor)
from kaldi_cnn_tpu_torch.core.rng import torch_generator  # noqa: E402
from kaldi_cnn_tpu_torch.features import functional as TF  # noqa: E402
from kaldi_cnn_tpu_torch.features.extractor import (  # noqa: E402
    FeatureExtractor as TExtractor)

KS_SAMPLE = 200_000


def summary(a: np.ndarray) -> dict:
    a = np.asarray(a, np.float64).reshape(-1)
    return {"elements": int(a.size), "mean": float(a.mean()),
            "std": float(a.std())}


def ks(a: np.ndarray, b: np.ndarray, seed: int = 0) -> dict:
    """Two-sample KS on at most KS_SAMPLE elements of each side."""
    rng = np.random.default_rng(seed)
    a, b = np.ravel(a), np.ravel(b)
    a = a if a.size <= KS_SAMPLE else rng.choice(a, KS_SAMPLE, False)
    b = b if b.size <= KS_SAMPLE else rng.choice(b, KS_SAMPLE, False)
    r = stats.ks_2samp(a, b)
    return {"ks": float(r.statistic), "ks_p": float(r.pvalue)}


def raw_frame_opts(kind: str, sample_rate: int, pkg_f):
    """The recipe's options with everything after the dither turned off."""
    opts = pkg_f.MfccOptions() if kind == "mfcc" else pkg_f.FbankOptions()
    fo = opts.frame_opts
    fo.samp_freq = float(sample_rate)
    fo.dither = 1.0
    fo.remove_dc_offset = False
    fo.preemph_coeff = 0.0
    fo.window_type = "rectangular"
    fo.round_to_power_of_two = False
    return opts


def jax_noise(waves, kind: str, sample_rate: int, seed: int):
    """{utt: [T, window]} the JAX extractor's dither on zero waves."""
    opts = raw_frame_opts(kind, sample_rate, JF)
    ex = JExtractor(kind, opts, bucket_seconds=1.0, device="cpu",
                    use_pallas=False)
    ex._fn = lambda wave, o, key: JF.frame_signal(
        wave, o.frame_opts, key)[0]
    zeros = {u: np.zeros_like(w, np.float32) for u, w in waves.items()}
    return ex.extract_corpus(zeros, stage_key(seed, f"{kind}_dither"))


def port_noise(waves, kind: str, sample_rate: int, seed: int):
    """{utt: [T, window]} the port's dither on zero waves (the CPU)."""
    opts = raw_frame_opts(kind, sample_rate, TF)
    ex = TExtractor(opts, device="cpu")
    ex._fn = lambda x, o, gen: TF.frame_signal(x, o.frame_opts, gen)[0]
    zeros = {u: np.zeros_like(w, np.float32) for u, w in waves.items()}
    return ex.extract_corpus(zeros, seed)


def corpora():
    """(recipe, seed, kind, {set: corpus}) as the recipes draw them."""
    from kaldi_cnn_tpu_torch.recipes import rm, wsj
    tr, dv, te = rm.make_corpus(140, 29, 0)
    yield "rm", 29, "mfcc", {"train": tr, "dev": dv, "test": te}
    train, dev, test = wsj.split_corpus(wsj.make_corpus(160, 37))
    sets = {"train": train, "dev": dev, "test": test}
    yield "wsj", 37, "mfcc", {"train": train}
    yield "wsj", 37, "fbank", sets


def dither_lines():
    offsets = {"train": 0, "dev": 1, "test": 2}
    for recipe, seed, kind, sets in corpora():
        streams = {}
        for name, corpus in sets.items():
            s = seed + offsets[name]
            j = jax_noise(corpus.waves, kind, corpus.sample_rate, s)
            t = port_noise(corpus.waves, kind, corpus.sample_rate, s)
            shapes_equal = all(j[u].shape == t[u].shape for u in j)
            ja = np.concatenate([v.ravel() for v in j.values()])
            ta = np.concatenate([v.ravel() for v in t.values()])
            yield {"draw": "dither", "recipe": recipe, "kind": kind,
                   "set": name, "seed": s, "utts": len(j),
                   "shape_0": list(next(iter(t.values())).shape),
                   "shapes_equal": shapes_equal,
                   "jax": summary(ja), "port": summary(ta), **ks(ja, ta)}
            streams[name] = (j, t)
        yield stream_line(recipe, kind, streams)


def stream_line(recipe: str, kind: str, streams) -> dict:
    """The largest |correlation| between the first 4000 noise values of
    any two utterances, within and across the sets, per package, and
    whether two utterances drew identical noise."""
    out = {"draw": "streams", "recipe": recipe, "kind": kind}
    for p, pkg in enumerate(("jax", "port")):
        rows = []
        for name in streams:
            for u, v in sorted(streams[name][p].items())[:24]:
                rows.append(v.ravel()[:4000])
        n = min(len(r) for r in rows)
        m = np.stack([r[:n] for r in rows])
        c = np.corrcoef(m)
        np.fill_diagonal(c, 0.0)
        dup = int(sum(np.array_equal(m[i], m[k]) for i in range(len(m))
                      for k in range(i + 1, len(m))))
        out[pkg] = {"pairs": len(m) * (len(m) - 1) // 2,
                    "max_abs_corr": float(np.abs(c).max()),
                    "bound_4_sigma": 4.0 / np.sqrt(n),
                    "identical_pairs": dup}
    return out


def init_lines():
    from kaldi_cnn_tpu.models import factory as jfac
    from kaldi_cnn_tpu_torch.models import factory as tfac
    nets = {
        "rm_pnorm_dnn": lambda f, **kw: f.make_pnorm_dnn(f.PnormDnnConfig(
            input_dim=180, num_hidden_layers=2, pnorm_input_dim=800,
            pnorm_output_dim=160, num_pdfs=200), **kw),
        "wsj_cnn": lambda f, **kw: f.make_convnet(f.ConvnetConfig(
            in_t=11, in_f=36, in_c=3, filt_t=4, filt_f=7, num_filters=64,
            pool_t=2, pool_f=3, pool_c=1, num_hidden_layers=2,
            pnorm_input_dim=1000, pnorm_output_dim=200, num_pdfs=300),
            **kw),
    }
    for name, make in nets.items():
        for seed in (29, 37):
            jnet = make(jfac, use_pallas=False) if name == "wsj_cnn" else \
                make(jfac)
            jp = jnet.init(jax.random.PRNGKey(
                int(stage_key(seed, "init")[1])))
            tnet = make(tfac, device="cpu").init(
                torch_generator(seed, "init"))
            for i, (jc, tc) in enumerate(zip(jp, tnet.components)):
                for k in ("w", "b"):
                    if k not in jc:
                        continue
                    ja = np.asarray(jc[k])
                    ta = getattr(tc, k).detach().numpy()
                    yield {"draw": "init", "net": name, "seed": seed,
                           "component": i, "type": type(tc).__name__,
                           "param": k, "shape_jax": list(ja.shape),
                           "shape_port": list(ta.shape),
                           "jax": summary(ja), "port": summary(ta),
                           **ks(ja, ta)}


def numpy_lines():
    from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm as JGmm
    from kaldi_cnn_tpu.train.egs import Egs as JEgs, EgsBatcher as JB
    from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm as TGmm
    from kaldi_cnn_tpu_torch.train.egs import Egs as TEgs, EgsBatcher as TB
    from kaldi_cnn_tpu.core.rng import np_rng as jrng
    from kaldi_cnn_tpu_torch.core.rng import np_rng as trng
    g = np.random.default_rng(0)
    w = np.full(4, 0.25)
    m = g.normal(size=(4, 39))
    v = g.uniform(0.5, 2.0, (4, 39))
    a = JGmm(w, m, v).split(16, np.random.default_rng(29))
    b = TGmm(w, m, v).split(16, np.random.default_rng(29))
    yield {"draw": "gmm_split", "dim": 39, "from": 4, "to": 16,
           "bit_equal": bool(np.array_equal(a.means, b.means)
                             and np.array_equal(a.weights, b.weights))}
    n = 20000
    yield {"draw": "egs_shuffle", "rows": n,
           "bit_equal": bool(np.array_equal(
               jrng(37, "cnn_egs_shuffle").permutation(n),
               trng(37, "cnn_egs_shuffle").permutation(n)))}
    x = np.zeros((n, 1), np.float32)
    y = np.arange(n, dtype=np.int32)
    wts = np.ones(n, np.float32)
    jb, tb = JB(JEgs(x, y, wts), 256, 29), TB(TEgs(x, y, wts), 256, 29)
    same = all(np.array_equal(np.asarray(jy), np.asarray(ty))
               for e in range(3)
               for (_, jy, _), (_, ty, _) in zip(jb.epoch(e), tb.epoch(e)))
    yield {"draw": "egs_epoch_order", "rows": n, "epochs": 3,
           "bit_equal": bool(same)}


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    for gen in (numpy_lines, init_lines, dither_lines):
        for line in gen():
            print(json.dumps({"device": "cpu", **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
