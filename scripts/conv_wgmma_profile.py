#!/usr/bin/env python3
"""What the tensor-core conv+maxpool kernel costs, on one NVIDIA GPU.  Run
from the root of the repository:

    python3 scripts/conv_wgmma_profile.py

It prints the registers and spills that ptxas reports for each
instantiation of the wgmma kernel in
``kaldi_cnn_tpu_torch/csrc/conv_maxpool.cu`` (a compile with
``-Xptxas -v`` into ``kaldi_cnn_tpu_torch/_build/profile/``), then, for the
bench (F = 128) and recipe (F = 64) shapes at 4096 rows, the kernel as
shipped: the time a call from CUDA events over back-to-back calls, the time
a call inside a CUDA graph of 20 calls (no host work between launches),
and the rates these give against the bytes a call must move and its
products.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kaldi_cnn_tpu_torch.ops import common  # noqa: E402

OUT = os.path.join(common.BUILD_DIR, "profile")
ROWS, IN_T, IN_F, IN_C, FILT_T, FILT_F, POOL_T, POOL_F = \
    4096, 11, 36, 3, 4, 7, 2, 3


def ptxas_lines() -> list:
    """ptxas' register and spill lines for the wgmma kernels."""
    os.makedirs(OUT, exist_ok=True)
    cmd = [common._nvcc()] + common.NVCC_FLAGS + [
        "-Xptxas", "-v", "-c", os.path.join(common.CSRC_DIR,
                                            "conv_maxpool.cu"),
        "-o", os.path.join(OUT, "conv_maxpool.o")]
    ptxas = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in ptxas.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "wgmma" in line else None
        elif name and ("registers" in line or "spill" in line):
            nt = name.split("ILi")[1].split("E")[0]
            g = name.split("ELi")[1].split("E")[0]
            lines.append(f"wgmma kernel NT={nt} G={g}: {line.strip()}")
    return lines


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


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_wgmma_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print("\n".join(ptxas_lines()))
    fn = common.library().kcnn_conv_maxpool_wgmma
    rng = np.random.default_rng(0)
    K = FILT_T * FILT_F * IN_C
    out_t, out_f = IN_T - FILT_T + 1, IN_F - FILT_F + 1
    npos = (out_t // POOL_T) * (out_f // POOL_F)
    for nf in (128, 64):
        x = torch.as_tensor(rng.normal(size=(ROWS, IN_T * IN_F * IN_C))
                            .astype(np.float32), device=dev)
        w = torch.as_tensor(rng.normal(size=(nf, K)).astype(np.float32)
                            * 0.1, device=dev)
        b = torch.as_tensor(rng.normal(size=nf).astype(np.float32),
                            device=dev)
        out = torch.empty(ROWS, npos * nf, device=dev)

        def call():     # on the current stream, so a graph captures it
            common.check_launch("kcnn_conv_maxpool_wgmma", fn(
                x.data_ptr(), ROWS, w.data_ptr(), b.data_ptr(), IN_T, IN_F,
                IN_C, FILT_T, FILT_F, nf, POOL_T, POOL_F, 0, out.data_ptr(),
                common.stream_ptr(dev)))

        ev, gr = event_ms(call), graph_ms(call)
        nbytes = 4 * (x.numel() + w.numel() + b.numel() + out.numel())
        flops = 2 * ROWS * out_t * out_f * nf * K
        print(f"F={nf}: events {ev:.4f} ms/call, CUDA graph {gr:.4f} "
              f"ms/call; in the graph {nbytes / gr / 1e9:.3f} TB/s of "
              f"{nbytes / 1e6:.1f} MB, {flops / gr / 1e9:.1f} TFLOP/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
