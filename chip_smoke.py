#!/usr/bin/env python3
"""Smoke test of the PyTorch port (kaldi_cnn_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA GPU, nvcc
and the CUDA build of PyTorch:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kaldi_cnn_tpu_torch/csrc/`` and
then runs three phases; any failure raises and the exit code is not 0.

1. Kernel phase: each kernel against its plain PyTorch version on the
   same card and the same inputs, at the bench shapes (fbank on 12000
   frames of 16 kHz audio; conv+maxpool at ConvnetConfig() defaults,
   F = 128, 4096 rows) and at the WSJ slice's shapes (fbank on one
   8 kHz utterance, 36 bins; conv+maxpool at F = 64, 4096 rows), with
   the max error and both times from CUDA events.
2. Slice phase: the WSJ-style recipe's serving path at the recipe's
   model width (F = 64, 2 x (Affine 1000 -> Pnorm 200 -> Normalize),
   num_pdfs from the graph), seeded random weights, on 16 synthetic
   utterances: fbank volumes -> splice -> AmNnet.loglikes_batch ->
   TopKDecoder.decode_batch -> WER, through ``recipes.wsj.decode``.
   The launch count of every kernel in that run must be > 0.
3. Replay: the same slice, same weights and dither noise, through the
   plain versions on the CPU; loglikes must agree within LOGLIKE_ATOL and
   the decoded words must be equal.

Output: the GPU's name and power limit (nvidia-smi), the build time, one
line per check, a JSON line {"kernels": [...]} and, last, the JSON line
{"ok": true, "device": {...}}.  Times are for the card named on the first
line and hold only for its power limit.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.topk_decoder import TopKDecoder
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.models.components import (
    AffineComponent, Conv2DComponent)
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.ops import common
from kaldi_cnn_tpu_torch.ops.conv import (conv2d_maxpool,
                                          conv2d_maxpool_reference)
from kaldi_cnn_tpu_torch.ops.fbank import fbank_frames, fbank_reference_frames
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj

SEED = 37
FBANK_ATOL = 1e-3         # log-mel and log energy, kernel vs plain (f32)
CONV_F32_TOL = 2e-4       # rtol = atol, kernel vs plain, both f32
CONV_BF16_REL = 0.02      # bf16 kernel vs f32 plain: max err / max|ref|
# loglikes on the card vs the CPU replay: both round the conv operands
# to bf16, and the features they round differ in the last f32 bits
# (the card's fbank kernel vs the CPU's matmul), which moves an input
# across a bf16 rounding boundary now and then (one bf16 step is 2^-8
# relative)
LOGLIKE_ATOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over iters back-to-back calls (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fbank_case(name, opts, wave, dev):
    fo = opts.frame_opts
    frames = F.add_dither(
        F.extract_frames(torch.as_tensor(wave, device=dev), fo), fo,
        torch_generator(SEED, name)).contiguous()
    out, energy = fbank_frames(frames, opts)
    ref, ref_e = fbank_reference_frames(frames, opts)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    err_e = float((energy - ref_e).abs().max())
    ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
          and err <= FBANK_ATOL and err_e <= FBANK_ATOL)
    r = {"name": name, "shape": f"{frames.shape[0]} frames x "
         f"{fo.window_size} samples -> {opts.mel_opts.num_bins} bins",
         "max_abs_err": err, "energy_err": err_e,
         "ms": time_ms(lambda: fbank_frames(frames, opts)),
         "plain_ms": time_ms(lambda: fbank_reference_frames(frames, opts))}
    nb = fo.padded_window_size // 2 + 1
    flops = frames.shape[0] * (4 * fo.window_size * nb
                               + 2 * nb * opts.mel_opts.num_bins)
    log(f"kernel fbank {name}: {r['shape']}: log-mel max err {err:.3g}, "
        f"energy max err {err_e:.3g} (limit {FBANK_ATOL}); kernel "
        f"{r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.2f} TFLOP/s), plain "
        f"{r['plain_ms']:.4f} ms")
    if not ok:
        raise AssertionError(f"fbank kernel disagrees with plain: {r}")
    return r


def conv_case(name, cfg, rows, dev):
    conv = Conv2DComponent(cfg.in_t, cfg.in_f, cfg.in_c, cfg.filt_t,
                           cfg.filt_f, cfg.num_filters, device=dev)
    conv.init(torch_generator(SEED, name))
    rng = np_rng(SEED, name)
    x = torch.as_tensor(rng.normal(size=(rows, conv.input_dim))
                        .astype(np.float32), device=dev)
    w, b = conv.w.detach(), conv.b.detach()
    pt, pf = cfg.pool_t, cfg.pool_f
    out = {}
    for bf16 in (False, True):
        got = conv2d_maxpool(x, w, b, conv, pt, pf, bf16=bf16)
        ref = conv2d_maxpool_reference(x, w, b, conv, pt, pf, bf16=bf16)
        ref32 = conv2d_maxpool_reference(x, w, b, conv, pt, pf, bf16=False)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        close = bool(torch.allclose(got, ref, rtol=CONV_F32_TOL,
                                    atol=CONV_F32_TOL))
        rel32 = float((got - ref32).abs().max() / ref32.abs().max())
        mode = "bf16" if bf16 else "f32"
        r = {"name": f"{name} {mode}", "max_abs_err": err,
             "rel_err_vs_f32": rel32,
             "shape": f"{rows} rows x {conv.input_dim} -> {got.shape[1]}",
             "ms": time_ms(lambda: conv2d_maxpool(x, w, b, conv, pt, pf,
                                                  bf16=bf16)),
             "plain_ms": time_ms(lambda: conv2d_maxpool_reference(
                 x, w, b, conv, pt, pf, bf16=bf16))}
        flops = 2 * rows * conv.num_patches * conv.patch_dim \
            * conv.num_filters
        log(f"kernel conv_maxpool {name} {mode}: {r['shape']}: max err vs "
            f"plain {err:.3g} (rtol=atol={CONV_F32_TOL}), err vs f32 plain "
            f"/ max|ref| {rel32:.3g}; kernel {r['ms']:.4f} ms "
            f"({flops / r['ms'] / 1e9:.2f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f} ms")
        if not (close and bool(torch.isfinite(got).all())
                and (not bf16 or rel32 < CONV_BF16_REL)):
            raise AssertionError(f"conv kernel disagrees with plain: {r}")
        out[mode] = r
    return out


def wsj_model(num_pdfs: int, device) -> AmNnet:
    """The WSJ recipe's CNN (wsj.py run) with seeded random weights.  The
    output affine is drawn at 1/sqrt(fan_in) instead of the recipe's
    zero init, so the posteriors vary from frame to frame."""
    cfg = ConvnetConfig(
        in_t=11, in_f=36, in_c=3, filt_t=4, filt_f=7, num_filters=64,
        pool_t=2, pool_f=3, pool_c=1, num_hidden_layers=2,
        pnorm_input_dim=1000, pnorm_output_dim=200, num_pdfs=num_pdfs)
    net = make_convnet(cfg, fused=True, device=device)
    gen = torch_generator(SEED, "nnet_init")
    net.init(gen)
    out = [c for c in net.components if isinstance(c, AffineComponent)][-1]
    with torch.no_grad():
        out.w.copy_(torch.randn(out.w.shape, generator=gen)
                    / out.input_dim ** 0.5)
    return AmNnet(net, num_pdfs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    common.build(force=True)
    common.library()
    log(f"build: nvcc {' '.join(common.NVCC_FLAGS)} -> {common.LIB_PATH} "
        f"in {time.perf_counter() - t:.1f} s")

    # ---- corpus and graph (the slice's inputs) ------------------------
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_noisy_corpus(lex, wp, 16, 2, 5, seed=SEED)
    lang = Lang.create(lex)
    hclg = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())
    num_pdfs = lang.trans_model.num_pdfs

    # ---- 1. kernel phase ----------------------------------------------
    bench = F.FbankOptions()                        # 16 kHz, 23 bins
    bench.frame_opts.dither = 1.0
    nsamp = 11999 * bench.frame_opts.window_shift \
        + bench.frame_opts.window_size              # 12000 frames
    wave = (np_rng(SEED, "bench_wave").normal(size=nsamp) * 1000
            ).astype(np.float32)
    fbank_case("bench-16k", bench, wave, dev)
    slice_opts = F.FbankOptions()
    slice_opts.frame_opts.samp_freq = float(corpus.sample_rate)
    slice_opts.mel_opts.num_bins = 36
    utt0 = sorted(corpus.waves)[0]
    fb = fbank_case("wsj-8k", slice_opts, corpus.waves[utt0], dev)
    conv_case("bench-F128", ConvnetConfig(), 4096, dev)
    cv = conv_case("wsj-F64", ConvnetConfig(num_filters=64), 4096, dev)

    # ---- 2. slice phase -----------------------------------------------
    am = wsj_model(num_pdfs, dev)
    fbank_frames.launches = 0
    conv2d_maxpool.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = wsj.decode(am, corpus, hclg, lang.word_table, seed=SEED)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t
    launches = {"fbank": fbank_frames.launches,
                "conv_maxpool": conv2d_maxpool.launches}
    lls = res["loglikes"]
    frames = sum(v.shape[0] for v in lls.values())
    log(f"slice: {len(lls)} utterances, {frames} frames, launches "
        f"{launches}, wsj.decode {slice_s:.3f} s (fbank + scoring + "
        f"search + WER), WER {res['wer']:.2f}% ({res['errors']} errors / "
        f"{res['words']} words; random weights, not asserted)")
    for u, ll in lls.items():
        T = F.num_frames(len(corpus.waves[u]), slice_opts.frame_opts)
        if ll.shape != (T, num_pdfs) or not np.isfinite(ll).all():
            raise AssertionError(f"{u}: loglikes {ll.shape}, expected "
                                 f"finite ({T}, {num_pdfs})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the slice: {launches}")

    # where the slice's time goes (a second, warm run; not counted)
    vols = wsj.compute_fbank_volumes(corpus, seed=SEED, device=dev)
    t = time.perf_counter()
    vols = wsj.compute_fbank_volumes(corpus, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_fbank = time.perf_counter() - t
    spliced = {u: wsj.splice_volume(v, wsj.CONTEXT, wsj.CONTEXT)
               for u, v in vols.items()}
    t = time.perf_counter()
    am.loglikes_batch(spliced)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t
    dec = TopKDecoder(hclg, beam=60.0, max_active=2000,
                      acoustic_scale=wsj.ACOUSTIC_SCALE, device=dev)
    utts = sorted(lls)
    t = time.perf_counter()
    dec.decode_batch([lls[u] for u in utts])
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t
    log(f"slice breakdown (warm): fbank volumes {t_fbank:.3f} s, "
        f"loglikes_batch {t_score:.3f} s, decode_batch {t_search:.3f} s "
        f"({frames / 100.0:.1f} s of audio)")

    # ---- 3. CPU replay through the plain versions ---------------------
    am_cpu = AmNnet(copy.deepcopy(am.nnet).to("cpu"), num_pdfs)
    am_cpu.priors = am.priors.copy()
    t = time.perf_counter()
    res_cpu = wsj.decode(am_cpu, corpus, hclg, lang.word_table, seed=SEED)
    cpu_s = time.perf_counter() - t
    ll_err = max(float(np.abs(lls[u] - res_cpu["loglikes"][u]).max())
                 for u in lls)
    same_words = all(res["hyps"][u] == res_cpu["hyps"][u] for u in lls)
    # along one path, each frame's cost moves by at most scale * ll_err
    cost_ok = all(abs(res["costs"][u] - res_cpu["costs"][u])
                  <= 1e-2 + wsj.ACOUSTIC_SCALE * len(lls[u]) * ll_err
                  for u in lls)
    log(f"replay on cpu ({cpu_s:.1f} s): loglikes max abs diff {ll_err:.3g} "
        f"(limit {LOGLIKE_ATOL}), words equal: {same_words}, best-path "
        f"costs agree: {cost_ok}, CPU WER {res_cpu['wer']:.2f}%")
    if ll_err > LOGLIKE_ATOL or not same_words or not cost_ok:
        raise AssertionError("the card's slice disagrees with the CPU replay")

    kernels = [
        {"name": "fbank", "route": "cuda",
         "source": "kaldi_cnn_tpu_torch/csrc/fbank.cu",
         "replaces": "kaldi_cnn_tpu/ops/fbank_pallas.py:63",
         "launches": launches["fbank"], "max_abs_err": fb["max_abs_err"],
         "ms": fb["ms"], "plain_ms": fb["plain_ms"]},
        {"name": "conv_maxpool", "route": "cuda",
         "source": "kaldi_cnn_tpu_torch/csrc/conv_maxpool.cu",
         "replaces": "kaldi_cnn_tpu/ops/conv_pallas.py:43",
         "launches": launches["conv_maxpool"],
         "max_abs_err": cv["bf16"]["max_abs_err"], "ms": cv["bf16"]["ms"],
         "plain_ms": cv["bf16"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
