#!/usr/bin/env python3
"""What the design choices of the vectorised maxpool kernels and the FFT
fbank kernels buy, on one NVIDIA GPU.  Run from the root of the repository:

    python3 scripts/kernel_variants.py

It compiles variants of ``kaldi_cnn_tpu_torch/csrc/maxpool.cu`` and
``fbank.cu``, each the shipped source with one choice undone by a textual
patch, into ``kaldi_cnn_tpu_torch/_build/variants/`` (one nvcc each, all
in parallel), prints ptxas' registers and spills of the shipped kernels,
and times every variant against the shipped one, in turns, as the time a
call inside a CUDA graph of 20 calls:

* maxpool forward at the bench shape (8x30x128, 4096 rows, pool 2x3x1),
  f32 and bf16, with and without the argmax: the L1::no_allocate or
  evict-first (.cs) load hints instead of plain ld.global.nc, blocks of
  128 or 256 threads instead of 64; and ``amax`` over the window;
* maxpool backward at the bench shape, f32 and bf16: plain stores
  instead of streaming ones (__stcs), blocks of 128 or 256 threads; and
  a memset of the same output (``zero_()``), the card's write rate;
* fbank at 16 kHz (12000 frames) and 8 kHz (238 frames): the FFT kernel
  without its mel stage (what that stage costs);
* the mixed-radix fbank (round_to_power_of_two off) at 16 kHz (N = 400,
  12000 and 238 frames) and 8 kHz (N = 200, 238 frames): blocks of 2
  warps instead of 8, and without its mel stage, its real-FFT post-pass
  or its in-register DFT (what each stage costs); and the shipped FFT
  kernels' SASS instructions a thread, by kind (cuobjdump).

Every variant's output is checked against the plain version first (the
mel-less fbank excepted: it computes something else).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kaldi_cnn_tpu_torch.core.rng import torch_generator  # noqa: E402
from kaldi_cnn_tpu_torch.features import functional as F  # noqa: E402
from kaldi_cnn_tpu_torch.ops import common  # noqa: E402
from kaldi_cnn_tpu_torch.ops import fbank as fb  # noqa: E402
from kaldi_cnn_tpu_torch.ops import maxpool as mp  # noqa: E402

OUT = os.path.join(common.BUILD_DIR, "variants")
LOAD = "v[c] = __ldg(reinterpret_cast<const uint4*>(\n"
BLOCK = "constexpr int kVecThreads = 64;"
MEL = "acc = fmaf(pw[k + (k >> 5)], __ldg(bw + j * M + m), acc);"
BWD_STORE = "__stcs(reinterpret_cast<uint4*>(\n                   dr +"
MIXED_MEL = "acc = fmaf(p[first + jj], __ldg(bw + jj * M + m), acc);"
MIXED_WARPS = "constexpr int kWarps = 8, F = 32 / L;"
MIXED_POST = ("power_mixed<L>(z, l, tw, pwf, "
              "std::make_integer_sequence<int, kP>());")
MIXED_DFT = "dft25<L>(z, tw);"


def patched(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"variant patch does not apply: {old!r}")
    return src.replace(old, new)


def variants():
    """{name: patched source}."""
    pool = open(os.path.join(common.CSRC_DIR, "maxpool.cu")).read()
    fbank = open(os.path.join(common.CSRC_DIR, "fbank.cu")).read()
    hint = "v[c] = ld_hinted(reinterpret_cast<const uint4*>(\n"
    no_allocate = patched(pool, LOAD, hint).replace(
        "struct WordMax;", "struct WordMax;\n__device__ __forceinline__ uint4 "
        "ld_hinted(const uint4* p) {\n  uint4 v;\n  asm(\"ld.global.nc."
        "L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
        "      : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w)"
        " : \"l\"(p));\n  return v;\n}", 1)
    return {
        "maxpool shipped": pool,
        "maxpool L1::no_allocate": no_allocate,
        "maxpool .cs (__ldcs)": patched(
            pool, LOAD, "v[c] = __ldcs(reinterpret_cast<const uint4*>(\n"),
        "maxpool 128 threads": patched(
            pool, BLOCK, "constexpr int kVecThreads = 128;"),
        "maxpool 256 threads": patched(
            pool, BLOCK, "constexpr int kVecThreads = 256;"),
        "maxpool bwd plain stores": patched(
            pool, BWD_STORE, "st_plain(reinterpret_cast<uint4*>(\n"
            "                   dr +").replace(
            "struct WordMax;", "struct WordMax;\n__device__ __forceinline__ "
            "void st_plain(uint4* p, uint4 v) { *p = v; }", 1),
        "fbank shipped": fbank,
        "fbank without mel": patched(fbank, MEL, "acc += pw[k + (k >> 5)];"),
        "mixed shipped": fbank,
        "mixed 2 warps a block": patched(
            fbank, MIXED_WARPS, "constexpr int kWarps = 2, F = 32 / L;"),
        "mixed without mel": patched(fbank, MIXED_MEL,
                                     "acc += p[first + jj];"),
        "mixed without post-pass": patched(
            fbank, MIXED_POST, "for (int r = 0; r < kP; ++r) pwf[(r * L + l) "
            "% H] = z[r].x * z[r].x + z[r].y * z[r].y;"),
        "mixed without DFT": patched(fbank, MIXED_DFT, ""),
    }


def short_name(mangled: str):
    """maxpool_fwd_vec_kernel<T, A, PT, PF> or fbank_fft_kernel<R> from a
    mangled name; None for the other kernels."""
    m = re.search(r"maxpool_fwd_vec_kernelI(f|13__nv_bfloat16)([vai])"
                  r"Li(\d+)ELi(\d+)E", mangled)
    if m:
        t = "float" if m.group(1) == "f" else "bf16"
        a = {"v": "no argmax", "a": "int8", "i": "int32"}[m.group(2)]
        return f"maxpool_fwd_vec_kernel<{t}, {a}, {m.group(3)}, {m.group(4)}>"
    m = re.search(r"maxpool_bwd_vec_kernelI(f|13__nv_bfloat16)([ai])"
                  r"Li(\d+)ELi(\d+)E", mangled)
    if m:
        t = "float" if m.group(1) == "f" else "bf16"
        a = {"a": "int8", "i": "int32"}[m.group(2)]
        return f"maxpool_bwd_vec_kernel<{t}, {a}, {m.group(3)}, {m.group(4)}>"
    m = re.search(r"fbank_mixed_kernelILi(\d+)E", mangled)
    if m:
        return f"fbank_mixed_kernel<L={m.group(1)}>"
    m = re.search(r"fbank_fft_kernelILi(\d+)E", mangled)
    return f"fbank_fft_kernel<R={m.group(1)}>" if m else None


def build(vs):
    """Compiles every variant in parallel; returns {name: CDLL} and the
    shipped sources' ptxas lines for the two kernels."""
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for i, (name, src) in enumerate(vs.items()):
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [common._nvcc()] + common.NVCC_FLAGS + [
            "-Xptxas", "-v", "-shared", "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs, ptxas = {}, []
    for name, so, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(so)
        for fn in ("kcnn_maxpool_fwd_vec", "kcnn_maxpool_bwd_vec",
                   "kcnn_fbank_fft", "kcnn_fbank_fft_mixed"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = common.SIGNATURES[fn]
        libs[name] = lib
        if name.endswith("shipped"):
            kernel = spill = None
            for line in err.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    kernel = short_name(m.group(1))
                elif kernel and "spill" in line:
                    spill = line.strip()
                elif kernel and "registers" in line:
                    ptxas.append(f"{kernel}: "
                                 f"{line.split(':', 1)[1].strip()}; {spill}")
                    kernel = None
    return libs, ptxas


def sass_counts(vs):
    """Static SASS instructions of the shipped FFT fbank kernels, by
    kind: all, shuffles, global and shared loads and stores, f32 math."""
    so = os.path.join(OUT, f"v{list(vs).index('fbank shipped')}.so")
    dump = subprocess.run(
        [os.path.join(os.path.dirname(common._nvcc()), "cuobjdump"), "-sass",
         so], capture_output=True, text=True, check=True).stdout
    kinds = {"SHFL": "SHFL", "LDG": "LDG", "LDS": "LDS", "STS": "STS",
             "STG": "STG", "FFMA": "F32", "FMUL": "F32", "FADD": "F32"}
    name, counts = None, {}
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_name(m.group(1)) or ""
            if name.startswith("fbank"):
                counts[name] = dict.fromkeys(["all", *dict.fromkeys(
                    kinds.values())], 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and name in counts and m.group(1) != "NOP":
            counts[name]["all"] += 1
            if m.group(1) in kinds:
                counts[name][kinds[m.group(1)]] += 1
    for name, c in counts.items():
        print(f"{name}: SASS " + ", ".join(f"{k} {v}" for k, v in c.items()),
              flush=True)


def event_ms(fn, iters=20):
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


def graph_ms(fn, calls=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, iters=5) / calls


def maxpool_rows(libs, dev):
    rows, nf = 4096, 128
    pool = mp.Pool3D(8, 30, nf, 2, 3, 1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(rows, 8 * 30 * nf)).astype(np.float32), device=dev).to(dtype)
        out = torch.empty(rows, 40 * nf, dtype=dtype, device=dev)
        arg = torch.empty(rows, 40 * nf, dtype=torch.int8, device=dev)
        want, want_arg = mp.maxpool3d_reference(x, pool, True)
        times = {}
        for _ in range(2):                  # in turns, twice
            for name, lib in libs.items():
                if not name.startswith("maxpool") or "bwd" in name:
                    continue
                for with_arg in (False, True):
                    def call(lib=lib, with_arg=with_arg):
                        common.check_launch("kcnn_maxpool_fwd_vec",
                                            lib.kcnn_maxpool_fwd_vec(
                            x.data_ptr(), rows, 8, 30, nf, 2, 3, 1,
                            int(dtype == torch.bfloat16), out.data_ptr(),
                            arg.data_ptr() if with_arg else None,
                            int(with_arg), common.stream_ptr(dev)))
                    call()
                    torch.cuda.synchronize()
                    if not (torch.equal(out, want) and (
                            not with_arg or torch.equal(arg, want_arg))):
                        raise AssertionError(f"{name} disagrees with plain")
                    times.setdefault((name, with_arg), []).append(
                        graph_ms(call))
        amax = graph_ms(lambda: x.view(rows, 4, 2, 10, 3, nf).amax(
            dim=(2, 4)))
        print(f"maxpool bench-F128 {str(dtype)[6:]}, {rows} rows: amax "
              f"{amax:.4f} ms, bound {(x.nbytes + out.nbytes) / 3.35e9:.4f}"
              f" ms without the argmax, "
              f"{(x.nbytes + out.nbytes + arg.nbytes) / 3.35e9:.4f} with it",
              flush=True)
        for (name, with_arg), t in times.items():
            print(f"  {name:26s} {'argmax' if with_arg else 'max   '} "
                  f"graph ms {' '.join(f'{v:.4f}' for v in t)}", flush=True)


def maxpool_bwd_rows(libs, dev):
    rows, nf = 4096, 128
    pool = mp.Pool3D(8, 30, nf, 2, 3, 1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(rows, 8 * 30 * nf)).astype(np.float32), device=dev).to(dtype)
        _, arg = mp.maxpool3d_reference(x, pool, True)
        d = torch.as_tensor(np.random.default_rng(1).normal(
            size=tuple(arg.shape)).astype(np.float32), device=dev).to(dtype)
        dx = torch.empty_like(x)
        want = mp.maxpool3d_backward_reference(d, arg, pool)
        times = {}
        for _ in range(2):                  # in turns, twice
            for name, lib in libs.items():
                if not name.startswith("maxpool") or "L1" in name or (
                        "cs" in name):
                    continue

                def call(lib=lib):
                    common.check_launch("kcnn_maxpool_bwd_vec",
                                        lib.kcnn_maxpool_bwd_vec(
                        d.data_ptr(), arg.data_ptr(), 1, rows, 8, 30, nf, 2,
                        3, 1, int(dtype == torch.bfloat16), dx.data_ptr(),
                        common.stream_ptr(dev)))
                call()
                torch.cuda.synchronize()
                if not torch.equal(dx, want):
                    raise AssertionError(f"{name} disagrees with plain")
                times.setdefault(name, []).append(graph_ms(call))
        # the card's write rate on the same bytes: a memset of dx
        zero = graph_ms(dx.zero_)
        print(f"maxpool backward bench-F128 {str(dtype)[6:]}, {rows} rows: "
              f"bound {(x.nbytes + d.nbytes + arg.nbytes) / 3.35e9:.4f} ms; "
              f"dx.zero_() {zero:.4f} ms ({dx.nbytes / zero / 1e9:.0f} GB/s)",
              flush=True)
        for name, t in times.items():
            print(f"  {name:26s} graph ms {' '.join(f'{v:.4f}' for v in t)}",
                  flush=True)


def mixed_rows(libs, dev):
    for sr, bins, T in ((16000, 23, 12000), (16000, 23, 238),
                        (8000, 36, 238)):
        opts = F.FbankOptions()
        opts.frame_opts.samp_freq = float(sr)
        opts.frame_opts.round_to_power_of_two = False
        opts.mel_opts.num_bins = bins
        fo = opts.frame_opts
        wave = torch.as_tensor((np.random.default_rng(1).normal(
            size=(T - 1) * fo.window_shift + fo.window_size) * 1000)
            .astype(np.float32), device=dev)
        frames = F.add_dither(F.extract_frames(wave, fo), fo,
                              torch_generator(1, "variants")).contiguous()
        ref, _ = fb.fbank_reference_frames(frames.double(), opts)
        p = fb._plan(opts, dev)
        out = torch.empty(T, bins, device=dev)
        energy = torch.empty(T, device=dev)
        times = {}
        for _ in range(2):
            for name, lib in libs.items():
                if not name.startswith("mixed"):
                    continue

                def call(lib=lib):
                    common.check_launch(
                        "kcnn_fbank_fft_mixed", lib.kcnn_fbank_fft_mixed(
                            frames.data_ptr(), T, fo.window_size, p.n,
                            p.twiddle.data_ptr(), p.window.data_ptr(),
                            p.bands.data_ptr(), p.band_w.data_ptr(), bins,
                            float(fo.preemph_coeff),
                            int(fo.remove_dc_offset), out.data_ptr(),
                            energy.data_ptr(), common.stream_ptr(dev)))
                call()
                torch.cuda.synchronize()
                if name in ("mixed shipped", "mixed 2 warps a block") and (
                        float((out.double() - ref).abs().max()) > 1e-3):
                    raise AssertionError(f"{name} disagrees with plain")
                times.setdefault(name, []).append(graph_ms(call))
        print(f"mixed fbank {sr // 1000} kHz (N {fo.padded_window_size}), "
              f"{T} frames:", flush=True)
        for name, t in times.items():
            print(f"  {name:26s} graph ms {' '.join(f'{v:.4f}' for v in t)}",
                  flush=True)


def fbank_rows(libs, dev):
    for sr, bins, T in ((16000, 23, 12000), (8000, 36, 238)):
        opts = F.FbankOptions()
        opts.frame_opts.samp_freq = float(sr)
        opts.mel_opts.num_bins = bins
        fo = opts.frame_opts
        wave = torch.as_tensor((np.random.default_rng(1).normal(
            size=(T - 1) * fo.window_shift + fo.window_size) * 1000)
            .astype(np.float32), device=dev)
        frames = F.add_dither(F.extract_frames(wave, fo), fo,
                              torch_generator(1, "variants")).contiguous()
        ref, _ = fb.fbank_reference_frames(frames.double(), opts)
        p = fb._plan(opts, dev)
        out = torch.empty(T, bins, device=dev)
        energy = torch.empty(T, device=dev)
        times = {}
        for _ in range(2):
            for name, lib in libs.items():
                if not name.startswith("fbank"):
                    continue

                def call(lib=lib):
                    common.check_launch("kcnn_fbank_fft", lib.kcnn_fbank_fft(
                        frames.data_ptr(), T, fo.window_size, p.n,
                        p.twiddle.data_ptr(), p.window.data_ptr(),
                        p.bands.data_ptr(), p.band_w.data_ptr(), bins,
                        float(fo.preemph_coeff),
                        int(fo.remove_dc_offset), out.data_ptr(),
                        energy.data_ptr(), common.stream_ptr(dev)))
                call()
                torch.cuda.synchronize()
                if name.endswith("shipped") and float(
                        (out.double() - ref).abs().max()) > 1e-3:
                    raise AssertionError(f"{name} disagrees with plain")
                times.setdefault(name, []).append(graph_ms(call))
        print(f"fbank {sr // 1000} kHz, {T} frames:", flush=True)
        for name, t in times.items():
            print(f"  {name:26s} graph ms {' '.join(f'{v:.4f}' for v in t)}",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    vs = variants()
    libs, ptxas = build(vs)
    print("\n".join(ptxas))
    sass_counts(vs)
    maxpool_rows(libs, dev)
    maxpool_bwd_rows(libs, dev)
    fbank_rows(libs, dev)
    mixed_rows(libs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
