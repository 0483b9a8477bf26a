#!/usr/bin/env python3
"""Smoke test of the PyTorch port (kaldi_cnn_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA GPU, nvcc
and the CUDA build of PyTorch:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kaldi_cnn_tpu_torch/csrc/`` and
then runs these phases; any failure raises and the exit code is not 0.

1. Kernel phase: each kernel against its plain PyTorch version on the
   same card and the same inputs, at the bench shapes (fbank on 12000
   frames of 16 kHz audio; conv+maxpool at ConvnetConfig() defaults,
   F = 128, 4096 rows; maxpool forward, with and without the argmax, and
   backward on that conv output) and at the WSJ slice's shapes (fbank on
   one 8 kHz utterance, 36 bins, and one 0.2 s streaming chunk of it at
   36 bins and at the MFCC's 23 bins; conv+maxpool at F = 64, 4096 rows
   and at the 512 rows that AmNnet.loglikes pads a streaming chunk to;
   maxpool at F = 64 and 256 rows, the recipe's minibatch, and with
   pool_c = 2) and at the Switchboard recipe's (conv+maxpool at F = 48,
   4096 and 512 rows; maxpool on its 8x30x48 output at 256 rows), with
   the error and both times from CUDA events.
   Fbank runs the FFT kernel the wrapper picks, held against the plain
   version in float64 (and f32): the power-of-two kernel at those sizes,
   and with round_to_power_of_two off the mixed-radix kernel at the
   bench's 12000 frames (N = 400) and the WSJ utterance (N = 200); and
   the table kernel at the same shapes.
   Conv+maxpool runs both kernels: bf16 operands on the tensor cores
   (wgmma) and f32 on the CUDA cores.  Maxpool runs the forward and the
   backward the wrappers pick (the vectorised kernels at the recipe's
   shapes, the scalar ones at pool_c = 2) and the scalar forward and
   backward.  Each line also
   gives the time a call inside a CUDA graph of 20 calls (fbank,
   maxpool), the fbank wrapper's host microseconds a call, the kernel's
   bound (bytes over the HBM rate or operations over the peak rate, the
   larger) and the time of one PyTorch call computing the same function
   where there is one (``library_ms``, and ``library_graph_ms`` inside a
   CUDA graph: F.conv2d + F.max_pool2d through cuDNN; amax, max_pool3d
   with indices and its backward; none for fbank).  The port never calls
   those.  The maxpool kernels must be
   bit-equal to their plain versions, in f32 and bf16.
2. Slice phase: the WSJ-style recipe's serving path at the recipe's
   model width (F = 64, 2 x (Affine 1000 -> Pnorm 200 -> Normalize),
   num_pdfs from the graph), seeded random weights, on 16 synthetic
   utterances: fbank volumes -> splice -> AmNnet.loglikes_batch ->
   TopKDecoder.decode_batch -> WER, through ``recipes.wsj.decode``.
   The launch counts of the FFT fbank kernel and of the wgmma
   conv+maxpool kernel in that run must be > 0 (the f32 conv kernel and
   the table fbank kernel are off the path).
3. Replay: the same slice, same weights and dither noise, through the
   plain versions on the CPU; loglikes must agree within LOGLIKE_ATOL and
   the decoded words must be equal.
4. Lattice slice: the recipe's production decode and scoring,
   ``recipes.wsj.decode_and_score`` with the phase-2 model on the two
   halves of the corpus (dev, test): fbank volumes -> loglikes_batch ->
   decode_utterances (top-K search with lattice records on the card at
   beam 60, max_active 2000 and the derived record capacity; lattices
   assembled, pruned and determinized on the host) -> score_sweep on dev
   -> best paths on test at the chosen point -> WER.  The fbank and
   conv+maxpool launches must be > 0 and no lattice buffer may overflow;
   each lattice's one-best must equal the host ``lattice_decode``'s on
   the same loglikes (words; cost within LAT_COST_REL / LAT_COST_ABS)
   and ``TopKDecoder.decode_batch``'s best path (words); a CPU replay
   must give the same one-best words, swept point and WERs.  The search
   runs as captured CUDA graphs (no call of the eager frame loop or
   backtrace); the same two ``decode_utterances`` calls with the eager
   search on the card (the private eager methods) must give the same
   lattices arc for arc, neither may overflow, and each run must
   assemble and determinize one lattice an utterance (no padded row);
   ``decode_batch`` captured and eager must give the same tids, words
   and cost bits, and the device backtrace the host ``_best_path``'s on
   the fetched histories.  Prints the lattices' sizes and, for each run,
   the seconds of the frame loop, fetch, assembly + prune, determinize
   (and the sweep), the graph captures, the RTF and the peak
   ``max_memory_allocated``.
5. Training slice: fbank volumes of the same 16 utterances on the card,
   equal alignments on the monophone graph, ``recipes.wsj.train`` at the
   recipe width for TRAIN_EPOCHS epochs (minibatch 256; its groups of
   steps through ``Nnet.train_steps``' CUDA graphs, no call of the
   eager loop), then ``recipes.wsj.decode`` of the trained model.  The
   FFT fbank, the vectorised maxpool forward and the maxpool backward
   kernels must run in the training, the wgmma conv+maxpool kernel in
   the decode, and the trained model's valid logprob must beat the
   initial model's.  5b: the same training twice under deterministic
   cuDNN, through the graphs and through the eager loop: every step's
   objf, the pre-combine parameters and NG states, the final parameters
   must be equal, bit for bit, and the graphed run's maxpool launches
   less its graphs' warm-up launches must equal the eager run's.
6. Training replay: the same training on the CPU from the same initial
   parameters and egs; per-step objf, the pre-combine parameters and the
   final valid logprob must agree within the bounds below.
7. Train-step time, eager and graphed: ms a step at the bench shape
   (ConvnetConfig(), minibatch 4096) and the recipe's (the WSJ CNN,
   minibatch 256), in groups of 8, in the NG warm-up and the steady
   state, the device's busy share (torch.profiler), the graphs'
   captures, and the maxpool kernels' share of the graphed step.
8. Recipe: ``recipes.wsj.run`` end to end on the card at the recipe's
   width (F = 64) on RECIPE_UTTS utterances with RECIPE_EPOCHS epochs
   and the matched p-norm DNN: MFCC through the fbank kernel, the GMM
   bootstrap (mono -> triphone tree) on the host, fbank volumes, CNN and
   DNN training, lattice decode of dev and test on the triphone HCLG,
   the paired sign test; then the CNN's ``wsj.fit`` again through the
   eager loop, whose maxpool launches must equal the graphed fit's less
   its graphs' warm-up launches.
   The fbank kernel must run in the "mfcc" stage,
   the fbank, maxpool forward and backward and wgmma conv kernels in the
   run, and no lattice buffer may overflow; one utterance's MFCC from
   the card must agree with ``mfcc_reference`` on the CPU on the same
   noise, cepstrum c within MFCC_REL x its lifter coefficient and the
   energy column within MFCC_ENERGY_ATOL.  Prints each stage's seconds,
   the tree's leaves, the graph's states and K, both WERs and the sign
   test (the WERs are not asserted).
9. Streaming: phase 8's artifacts (the triphone Lang and GMM, the CNN's
   parameters and priors) served through the online2 path on phase 8's
   test split (``wsj.split_corpus`` of the corpus phase 8 ran on) in
   STREAM_CHUNK_S chunks, one recognizer piece of the chunk's 20 frames
   a chunk: an OnlineRecognizer on the card with an
   OnlineFeaturePipeline("fbank", 36 bins, dither 0, CMVN frozen at
   zeros), a StreamingSplicer(+-5) around the CNN (each spliced row
   reordered from (t, c, f) to (t, f, c)) and a StreamingDecoder (each
   block of 16, 4 or 1 frames one CUDA graph replay, one fetch a chunk)
   over TopKDecoder(beam 60, max_active 2000).  The fbank and wgmma conv
   kernels must run in the phase; the streamed words and tids must equal
   TopKDecoder.decode_batch on the rows the decoder received (cost within
   STREAM_COST_ABS); the streamed loglikes must be within LOGLIKE_ATOL of
   the same pipeline finished in one call and spliced offline; all three
   block graphs must have been captured.  One utterance is replayed
   through the same objects on the CPU (same words), and the CPU's eager
   StreamingDecoder on the card's rows must give the card's tids, words
   and cost.  Then the
   online2-wav-latgen verb (cli.main) on the triphone GMM .mdl, the HCLG
   as text and the test waves, on the card and with --host-decode: the
   MFCC kernel launches > 0, each lattice's shortest path equals its hyp
   line, and the two runs give the same hyps.  Last, the bounded window:
   the triphone GMM's loglikes of all the test utterances as one stream
   (beam 30, acoustic scale 1, commit_every 16) must keep the traceback
   window within 8 x commit_every, commit >= 90 % of the path and equal
   decode_batch (the CNN's 3-epoch posteriors are too flat for the live
   tokens to merge, in the JAX package too, so its window is printed and
   not held).  Prints the streaming RTF, the median and p95 ms of an
   accept_waveform call, the split between features, AM and search, each
   graph's capture seconds and the verb's WERs (not asserted).
10. Switchboard recipe: ``recipes.swbd.run`` end to end on the card at
   the recipe's own size and width (24 speakers x 7 utterances, F = 48,
   a 12-dim iVector from a 16-Gaussian UBM, 2 x (Affine 800 -> Pnorm 160
   -> Normalize), SWBD_EPOCHS epochs): the fbank kernel must run in the
   "mfcc" stage, in the dev and test iVectors' MFCC and in the fbank
   volumes, the maxpool forward and backward kernels in "nnet_train"
   (inside SliceParallel(pool, Identity)), the wgmma conv+maxpool kernel
   in both decodes (through the pair of slices), and no lattice buffer
   may overflow.  Then the dev and test rows the decode got, with the
   card's trained parameters, through the plain versions on the CPU:
   loglikes within LOGLIKE_ATOL, each lattice's one-best words equal and
   the same swept point.  Prints each stage's seconds, the tree's
   leaves, the graph's states and K, and dev/test WER (not asserted).
11. RM recipe: ``recipes.rm.run`` end to end on the card at the recipe's
   widths (RM_UTTS utterances, seed 29, RM_EPOCHS epochs): MFCC + deltas
   through the fbank kernel, the host GMM chain (mono -> tri1 -> tri2b
   LDA+MLLT -> tri3b SAT with per-utterance fMLLR), the two-pass fMLLR
   GMM decode on the host, the p-norm DNN (180-dim fMLLR rows, 2 x
   (Affine 800 -> Pnorm 160 -> Normalize)) trained on the card and
   decoded through ``decode_utterances``.  The fbank kernel must run in
   each of the three ``compute_features`` calls, no lattice buffer may
   overflow, the result must carry the JAX recipe's keys and more than
   10 test words.  Then the test set's DNN rows, with the card's trained
   parameters, through the plain versions on the CPU: loglikes within
   LOGLIKE_ATOL, and ``decode_utterances`` on the CPU of the card's
   loglikes gives the card's one-best words.  Prints each stage's
   seconds and the GMM and DNN dev/test WERs (not asserted).
12. Librispeech recipe: ``recipes.librispeech.run`` end to end on the card
   at the recipe's defaults, uncut (LIBRI_UTTS utterances, seed 53, F =
   48, pnorm 800/160, minibatch 256, 8 on-disk egs shards, LIBRI_EPOCHS
   epochs) as a process group of one over NCCL: the MFCC GMM bootstrap
   (fbank kernel), the fbank volumes (fbank kernel), ``train_multihost``
   (maxpool forward and backward kernels, every sum over rows through
   an all-reduce; each step a replay of the dp step's CUDA graph, the
   all-reduces inside it, with no call of the eager loop) and the dev
   and test lattice decodes (wgmma conv+maxpool kernel) must each
   launch their kernels (the training's counts from the replays'
   captures), at least one all-reduce must reach the NCCL group, no
   lattice buffer may overflow, and the result must carry the JAX
   recipe's keys and more than 10 test words.  Then the test set's
   rows, with the card's trained parameters, through the plain versions
   on the CPU: loglikes within LOGLIKE_ATOL, and ``decode_utterances``
   on the CPU of the card's loglikes gives the card's one-best words.
   Then (12b) ``train_multihost`` at the recipe's net width over an
   NCCL group of one, NCCL_STEPS steps of DP_ROWS rows (the NG warm-up's
   64 refreshing steps, then refreshes every 16th), through the graphs
   and through the eager loop under deterministic cuDNN
   (``parallel/rank_check.py::nccl_graphs_vs_eager``): objfs, parameters
   and NG states bit-equal, the all-reduces and maxpool launches of the
   replays equal to the eager run's; prints ms a step of both in the
   warm-up and after it, with the card's name and power limit.  Last,
   two ranks on
   the one card over gloo with CUDA tensors (NCCL refuses two ranks on
   one GPU), at the recipe's net width and the run's pdfs: DP_STEPS
   mode-A steps, each rank holding half of a DP_ROWS minibatch, against
   the single-process steps on the whole of it, and two replicas of
   DP_STEPS steps and one average against the mean of the two
   single-process streams, and DP_STEPS tensor-parallel steps
   (``make_dp_tp_step``, data 1 x model 2: each rank half of every wide
   Affine layer's rows, the whole minibatch) against the single-process
   steps: objf within OBJF_STEP_ATOL, parameters within PARAM_REL, the
   two ranks bit-equal, the maxpool kernels launched in both (mode A and
   replicas).  Prints each stage's seconds, training audio-s/s, the
   all-reduce count and dev/test WER (not asserted).
13. MMI (run right after phase 9, on phase 8's artifacts before they
   are removed): ``train.discriminative.mmi_train_nnet`` on the card
   over phase 8's trained WSJ CNN (F = 64, its priors, the triphone
   HCLG) and the spliced fbank volumes and alignments of its first
   MMI_UTTS training utterances, MMI_ITERS iterations: each utterance
   scored by ``Nnet.predict`` (the wgmma conv+maxpool kernel), its
   denominator lattice from the host ``lattice_decode`` (beam 60, lattice
   beam 8, max_active 2000), then ``Nnet.discriminative_step`` (the
   maxpool forward with argmax and the backward).  All three kernels
   must launch in the phase, each frame's denominator occupancies must
   sum to 1 within MMI_DEN_ATOL, every objf must be finite and the net's
   NG update period must come back.  The first step is replayed on the
   CPU from the card's parameters, NG states and posteriors before it:
   objf within OBJF_STEP_ATOL, each parameter tensor within PARAM_REL.
   The steps replay CUDA graphs (one a (length, NG gates) key, captured
   at first use, a tail graph after each refresh's eighs); a copy of the
   net runs the same phase with ``discriminative_step_eager``, and under
   deterministic cuDNN the two give the same objf history, parameters
   and NG states bit for bit.  Prints the captures, the replays, the
   captures' seconds and the ms a step of both.
   Then an nnet2 chain at the MFCC width (Splice +-4 -> FixedAffine from
   ``estimate_feature_transform`` -> Affine -> RectifiedLinear -> Affine
   -> Tanh -> Affine -> Sigmoid -> Dropout -> Affine -> Softmax) is
   written to a .mdl and read on the card and on the CPU: one
   utterance's loglikes within LOGLIKE_ATOL, and one train step on the
   card with a Dropout generator gives a finite objf.  Prints the
   per-iteration objf (not asserted), the step's median ms, and the
   phase's seconds.
14. The command-line verbs (run right after phase 13, on phase 8's
   artifacts before they are removed), through ``cli.main`` on the card:
   (a) ``tests/test_cli_pipeline.py``'s shell pipeline on CLI_UTTS
   synthetic yesno utterances written by ``write_data_dir``:
   compute-mfcc-feats --dither=0 -> add-deltas -> prepare-lang ->
   gmm-train-mono -> compile-train-graphs -> gmm-align -> nnet-get-egs
   -> nnet-train -> mkgraph -> splice-feats -> latgen-faster
   --host-decode -> compute-wer (each verb's seconds, the WER, not
   asserted); (b) phase
   8's CNN written by ``write_am_nnet`` and its test utterances written
   as a data dir, through compute-fbank-feats --num-mel-bins=36
   --dither=0 -> add-deltas -> splice-feats +-5 -> latgen-faster on
   phase 8's triphone HCLG (beam 60, max_active 2000, lattice beam 8):
   its one-best words must equal ``wsj.nnet_decode``'s on
   ``compute_fbank_volumes(dither=0)`` of the same (int16) waves, and
   its loglikes those of the same verb with --device=cpu --host-decode
   within LOGLIKE_ATOL.  The fbank and conv+maxpool kernels must launch
   in the phase, which must end within CLI_PHASE_S.
15. The lattice layer (run right after phase 14, on its files): (a)
   phase 14 (b)'s front end again in the phase (compute-fbank-feats ->
   add-deltas -> splice-feats -> latgen-faster on the card, so both
   kernels run in it), then the lattice verbs on those lattices:
   lattice-best-path must give latgen-faster's one-best on every
   utterance; lattice-copy npz -> Kaldi-binary ark -> npz, twice, must
   give the same ark bytes and the same lattices arc for arc; lattice-copy
   with no output prints every key; lattice-scale --acoustic-scale=0.1
   then lattice-best-path must equal lattice-best-path at that scale;
   lattice-lmrescore with the unigram ARPA the HCLG was built from, at
   --scale=-1 (which must move every one-best cost) and then +1, must
   give back every one-best with its cost within LM_COST_ATOL;
   lattice-prune, -determinize, -push, -minimize, -mbr-decode, -nbest and
   -to-post must give output for every key; the native Table reader
   (``io.native_io.ArkIndex``, built on this machine) must read
   compute-fbank-feats' ark equal to ``read_ark``.  (b) The big graph of
   ``bench.py:194`` (``make_big_graph``, BIG_GRAPH: >= 100,000 states and
   >= 1,000,000 arcs): 20 frames at beam 60, max_active 16384 on the card
   must give the host exact Viterbi's words and cost (BIG_COST_REL /
   BIG_COST_ABS); then BIG_UTTS x BIG_FRAMES frames at the reference
   settings (beam 15, max_active 7000, lattice beam 8): the best-path and
   lattice decodes, first with the captured search (the captures in
   those first calls) and then eager on the card, must give the same
   tids, words and cost bits and the same lattices arc for arc (the
   device backtrace also the host ``_best_path``'s on the fetched
   histories), and neither may overflow; prints each run's seconds and
   RTF (the captured also without its captures), its frame loop / fetch
   / assembly + prune seconds, each capture's seconds, the lattice arcs
   and the peak ``torch.cuda.max_memory_allocated``; the first
   BIG_COPY_UTTS lattices through lattice-copy (ark and back, arc for
   arc) and lattice-determinize.  The fbank and conv+maxpool
   kernels must launch in the phase, which must end within
   LATTICE_PHASE_S.  (c) The dense exact search
   (``DenseViterbiDecoder``, beam 1e9, max_active 0) on (b)'s graph:
   the 20-frame case must give the host exact Viterbi's words and cost
   (BIG_COST_REL / BIG_COST_ABS); over BIG_UTTS x BIG_FRAMES the captured
   frame blocks, a second replay and the eager frames must give the same
   tids, words and cost bits, and each utterance's exact cost must be at
   most the top-K best path's of (b) + BIG_COST_ABS (where the top-K kept
   no final state, the exact search's cheapest state at the last frame is
   the bound); prints the seconds with and without the captures, RTF,
   the histories' size, the peak ``max_memory_allocated`` and the
   utterances whose top-K words differ from the exact search's (the
   top-K's search error at the reference settings).  The phase must end
   within DENSE_PHASE_S.
16. Mode B (run right after phase 12's two ranks): ``make_replica_step``
   with MODE_B_REPLICAS replicas of the Librispeech net (phase 12's
   pdfs), each on DP_ROWS rows of its own, MODE_B_STEPS steps in the NG
   warm-up (every step refreshes, cut around its eighs in the graphs),
   through the step graphs and eagerly under deterministic cuDNN:
   objfs, parameters and NG states must be bit-equal, the replicas must
   have diverged and be one model after ``average_replicas``, and the
   maxpool kernels must launch; prints ms an R-step graphed against R
   single eager steps.

Output: the GPU's name and power limit (nvidia-smi), the build time, one
line per check, the total seconds, a JSON line {"kernels": [...]} (for
each kernel its launches in the recipe run of phase 8, the whole main
path, with each phase's count in ``launches_by_phase``, phase 9's as
its recognizer run "streaming" and its two verb runs "verb_card" and
"verb_host", phase 10's as "swbd", phase 11's as "rm", phase 12's as
"librispeech", phase 13's as "mmi", phase 14's as "cli", phase 15's as
"lattice", 15 (c)'s as "dense", phase 16's as "mode_b"; error, ms,
plain_ms, bound_ms, bound_by, library_ms, graph_ms and library_graph_ms,
at the main path's shapes, and the same at the Switchboard shapes under
"swbd_f48...") and, last, the JSON line {"ok": true,
"device": {...}}.  Times
are for the card named on the first line and hold only for its power
limit.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import glob
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as nnf

from kaldi_cnn_tpu_torch import cli, cli_train
from kaldi_cnn_tpu_torch.cli_train import AdvanceRecorder
from kaldi_cnn_tpu_torch.convert import (opt_from_jax, opt_to_numpy,
                                         params_from_jax, params_to_numpy)
from kaldi_cnn_tpu_torch.core import mesh as mesh_ops
from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
from kaldi_cnn_tpu_torch.decode import topk_decoder
from kaldi_cnn_tpu_torch.decode.biggraph import make_big_graph, sample_loglikes
from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode, viterbi_decode
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import (load_lattices, save_lattices,
                                                shortest_path)
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import (StreamingDecoder,
                                                     TopKDecoder)
from kaldi_cnn_tpu_torch.decode.tpu_decoder import DenseViterbiDecoder
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.gmm.train import align_equal
from kaldi_cnn_tpu_torch.io import native_io
from kaldi_cnn_tpu_torch.io.kaldi_io import read_ark
from kaldi_cnn_tpu_torch.io.kaldi_model import (read_am_nnet,
                                                write_am_nnet,
                                                write_gmm_model)
from kaldi_cnn_tpu_torch.io.wave import write_wave
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import (Lang, compile_training_graph,
                                           make_hclg_from_arpa)
from kaldi_cnn_tpu_torch.models import components as C
from kaldi_cnn_tpu_torch.models.components import (
    AffineComponent, Conv2DComponent)
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet, Nnet
from kaldi_cnn_tpu_torch.models.step_graphs import ng_states, with_states
from kaldi_cnn_tpu_torch.models.utils import estimate_feature_transform
from kaldi_cnn_tpu_torch.online2 import (OnlineCmvn, OnlineFeaturePipeline,
                                         OnlineRecognizer, StreamingSplicer)
from kaldi_cnn_tpu_torch.ops import common
from kaldi_cnn_tpu_torch.ops import fbank as fbank_ops
from kaldi_cnn_tpu_torch.ops import maxpool as mp
from kaldi_cnn_tpu_torch.ops.conv import (conv2d_maxpool, conv2d_maxpool_f32,
                                          conv2d_maxpool_reference)
from kaldi_cnn_tpu_torch.ops.fbank import fbank_frames, fbank_reference_frames
from kaldi_cnn_tpu_torch.parallel import rank_check
from kaldi_cnn_tpu_torch.recipes import (librispeech, rm, swbd, synthetic,
                                         wsj, yesno)
from kaldi_cnn_tpu_torch.recipes.datadir import (DataDir, write_data_dir,
                                                 write_lexicon_file)
from kaldi_cnn_tpu_torch.train.checkpoint import load_checkpoint
from kaldi_cnn_tpu_torch.train.discriminative import mmi_train_nnet

SEED = 37
FBANK_ATOL = 1e-3         # log-mel and log energy, kernel vs plain (f32)
FBANK_F64_ATOL = 1e-3     # the FFT kernel vs the float64 plain version
CONV_F32_TOL = 2e-4       # rtol = atol, kernel vs plain, both f32
CONV_BF16_TOL = 1e-3      # wgmma kernel vs bf16 plain: max err / max|ref|
CONV_BF16_REL = 0.02      # bf16 kernel vs f32 plain: max err / max|ref|
# loglikes on the card vs the CPU replay: both round the conv operands
# to bf16, and the features they round differ in the last f32 bits
# (the card's fbank kernel vs the CPU's matmul), which moves an input
# across a bf16 rounding boundary now and then (one bf16 step is 2^-8
# relative)
LOGLIKE_ATOL = 5e-2
# lattice one-best vs the host lattice decoder on the same loglikes (the
# JAX package's test limit)
LAT_COST_REL, LAT_COST_ABS = 1e-4, 5e-2
# maxpool kernels vs plain: bit-equal (both select input values)
# training on the card vs its CPU replay (sums in other orders, cuDNN vs
# CPU convolutions, cuSOLVER vs LAPACK eigh)
TRAIN_EPOCHS = 3          # cut from the recipe's 25
OBJF_STEP_ATOL = 1e-3     # per-step training objf
PARAM_REL = 1e-3          # pre-combine params, per tensor ||a-b|| / ||b||
VALID_ATOL = 1e-2         # final valid logprob
BENCH_TRAIN_ROWS = 4096
# the recipe run (wsj.run): cut from 160 utterances and 25 epochs
RECIPE_UTTS = 40
RECIPE_EPOCHS = 3
# MFCC on the card vs mfcc_reference on the CPU: log-mel agrees to 1e-3,
# the DCT is orthonormal and the lifter scales cepstrum c by up to 12
MFCC_REL = 2e-3           # cepstrum c: MFCC_REL * lifter_coeffs[c]
MFCC_ENERGY_ATOL = 1e-3   # column 0, the raw log energy
# streaming (phase 9): chunks of the recipe's test waves; the streamed
# best path vs decode_batch on the same rows (the JAX package's bar,
# tests/test_online2.py)
STREAM_CHUNK_S = 0.2
STREAM_COST_ABS = 1e-2
# the Switchboard recipe (swbd.run, phase 10) at the recipe's own size and
# width: 24 speakers x 7 utterances, F = 48, iVector 12, pnorm 800/160;
# its depth cut from 25 epochs so that the script with phases 12 and 13
# stays near half its time limit (an epoch ~1.2 s of nnet_train on the
# card; 8 epochs give back what phase 13 takes)
SWBD_EPOCHS = 8
# the RM recipe (rm.run, phase 11) at its own widths (seed 29, pnorm
# 800/160 on 180-dim fMLLR rows, 25 epochs), its depth cut from 140
# utterances for the same reason (its host GMM chain grows with them;
# 70 until the script passed 700 s with phases 15 (c) and 16, 56 until
# the kernel phase took on the mixed-radix fbank and scalar backward cases)
RM_UTTS = 48
RM_EPOCHS = 25
# JAX rm.run's result: wer_details + the three WERs
RM_KEYS = {"wer", "errors", "words", "sub", "ins", "del", "missing_utts",
           "per_utt", "gmm_dev_wer", "dnn_dev_wer", "gmm_test_wer"}
# the Librispeech recipe (librispeech.run, phase 12) at its own defaults,
# uncut: 200 utterances, seed 53, F = 48, pnorm 800/160, minibatch 256,
# 8 egs shards, 25 epochs
LIBRI_UTTS = 200
LIBRI_EPOCHS = 25
# JAX librispeech.run's result keys
LIBRI_KEYS = {"wer", "errors", "words", "sub", "ins", "del", "missing_utts",
              "per_utt", "dev_wer", "train_audio_ss", "num_devices"}
# the two-rank check on the one card (gloo with CUDA tensors: NCCL refuses
# two ranks on one GPU): mode-A steps, and replica steps with one average
DP_STEPS = 4
DP_ROWS = 256
# train_multihost through the dp step's graphs against the eager loop
# over an NCCL group of one (phase 12b): the NG warm-up's 64 steps, then
# 48 with a refresh every 16th (3)
NCCL_STEPS = 112
# MMI (phase 13) on phase 8's trained CNN: mmi_train_nnet over the first
# MMI_UTTS training utterances for MMI_ITERS iterations at the JAX
# function's learning rate, and an nnet2 chain (.mdl) at the MFCC width
MMI_UTTS = 6
MMI_ITERS = 2
MMI_LR = 0.002
MMI_DEN_ATOL = 1e-3       # each frame's denominator occupancies sum to 1
MMI_PHASE_S = 40.0
CHAIN_HIDDEN = 512
# the verbs (phase 14): tests/test_cli_pipeline.py's yesno pipeline cut
# to CLI_UTTS utterances (from 50), CLI_MONO_ITERS mono iterations (from
# 18) and CLI_EPOCHS DNN epochs (from 12) to fit the phase's CLI_PHASE_S
CLI_UTTS = 40
CLI_MONO_ITERS = 14
CLI_EPOCHS = 8
CLI_PHASE_S = 40.0
# the lattice layer (phase 15): the verbs on latgen-faster's lattices of
# phase 8's CNN, then the big graph of bench.py:194 on the card
LATTICE_PHASE_S = 60.0
LM_COST_ATOL = 1e-3       # one-best cost after lmrescore at -1, then +1
BIG_GRAPH = dict(num_words=90_000, num_pdfs=256, min_len=4, max_len=8,
                 seed=3)
BIG_COST_REL, BIG_COST_ABS = 1e-4, 0.1   # top-K vs host exact Viterbi
BIG_UTTS, BIG_FRAMES = 16, 200
BIG_COPY_UTTS = 4
# the dense exact search (phase 15 (c)) on the big graph
DENSE_PHASE_S = 30.0
# mode B (phase 16): replicas of the Librispeech net in one process
MODE_B_REPLICAS, MODE_B_STEPS = 4, 8
# published H100 SXM peaks (NVIDIA data sheet, dense) for bound_ms
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


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


def bound(nbytes: float, flops: float, kind: str):
    """(least ms the card could take, what sets it): the bytes over the
    memory rate against the operations over the peak rate for ``kind``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def graph_ms(fn, calls: int = 20) -> float:
    """Device time a call of fn inside a CUDA graph of ``calls`` calls (no
    host work between the launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, iters=5) / calls


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of fn takes to return (the wrapper's own
    cost: checks, plan lookup, allocation, the ctypes launch), warm."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def fbank_work(opts, frames, out, energy):
    """(bytes, flops) of the fbank function, whatever implements it: the
    frames in, the log-mel and energy out, the mel band table and the
    twiddles; a real FFT of N points (2.5 N log2 N), 2 flops a mel
    weight, ~8 a sample for the front end.  And the flops of the DFT as
    two table products (the Pallas kernel's way), for a note."""
    fo = opts.frame_opts
    n, ws, T = fo.padded_window_size, fo.window_size, frames.shape[0]
    bands, band_w = fbank_ops.mel_bands(F.mel_banks(opts.mel_opts, fo))
    nbytes_ = (nbytes(frames, out, energy) + bands.nbytes + band_w.nbytes
               + 8 * (n + 64))
    flops = T * (2.5 * n * np.log2(n) + 2 * np.count_nonzero(band_w)
                 + 8 * ws)
    nb = n // 2 + 1
    table_flops = T * (4 * ws * nb + 2 * nb * opts.mel_opts.num_bins)
    return nbytes_, flops, table_flops


def fbank_case(name, opts, wave, dev):
    """The FFT kernel the wrapper picks at this size (the power-of-two
    one, or the mixed-radix one where round_to_power_of_two is off)
    against the float64 and the float32 plain version, and the table
    kernel at the same shape against the float32 plain version."""
    fo = opts.frame_opts
    frames = F.add_dither(
        F.extract_frames(torch.as_tensor(wave, device=dev), fo), fo,
        torch_generator(SEED, name)).contiguous()
    kind = fbank_ops.fbank_kernel(fo)
    counter = {"fft": fbank_frames,
               "mixed": fbank_ops.fbank_frames_mixed}.get(kind)
    if counter is None:
        raise AssertionError(f"{name}: the wrapper picks no FFT kernel")
    before = counter.launches
    out, energy = fbank_frames(frames, opts)
    if counter.launches != before + 1:
        raise AssertionError(f"{name}: the {kind} kernel did not launch")
    tab, tab_e = fbank_ops.fbank_frames_table(frames, opts)
    ref, ref_e = fbank_reference_frames(frames, opts)
    ref64, ref64_e = fbank_reference_frames(frames.double(), opts)
    torch.cuda.synchronize()
    err = lambda a, b: float((a.double() - b.double()).abs().max())
    err64 = max(err(out, ref64), err(energy, ref64_e))
    err32 = max(err(out, ref), err(energy, ref_e))
    err_tab = max(err(tab, ref), err(tab_e, ref_e))
    plain_err64 = max(err(ref, ref64), err(ref_e, ref64_e))
    ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
          and err64 <= FBANK_F64_ATOL and err32 <= FBANK_ATOL
          and err_tab <= FBANK_ATOL)
    moved, flops, table_flops = fbank_work(opts, frames, out, energy)
    b, by = bound(moved, flops, "f32")
    fft = lambda: fbank_frames(frames, opts)
    table = lambda: fbank_ops.fbank_frames_table(frames, opts)
    r = {"name": name, "kernel": kind,
         "shape": f"{frames.shape[0]} frames x "
         f"{fo.window_size} samples (N {fo.padded_window_size}) -> "
         f"{opts.mel_opts.num_bins} bins",
         "max_abs_err": err64, "err_vs_f32": err32, "bound_ms": b,
         "bound_by": by, "library_ms": None,   # no one call computes fbank
         "ms": time_ms(fft), "graph_ms": graph_ms(fft),
         "host_us": host_us(fft),
         "plain_ms": time_ms(lambda: fbank_reference_frames(frames, opts))}
    r["table"] = {"max_abs_err": err_tab, "ms": time_ms(table),
                  "graph_ms": graph_ms(table), "plain_ms": r["plain_ms"],
                  "bound_ms": b, "bound_by": by, "library_ms": None}
    table_bound = bound(moved, table_flops, "f32")[0]
    log(f"kernel fbank {name}: {r['shape']}: {kind} FFT kernel vs float64 "
        f"plain "
        f"max err {err64:.3g} (limit {FBANK_F64_ATOL}), vs f32 plain "
        f"{err32:.3g} (limit {FBANK_ATOL}; f32 plain vs float64 "
        f"{plain_err64:.3g}); FFT {r['ms']:.4f} ms by events, "
        f"{r['graph_ms']:.4f} ms in a CUDA graph, wrapper host "
        f"{r['host_us']:.1f} us a call; table kernel (err vs f32 plain "
        f"{err_tab:.3g}) {r['table']['ms']:.4f} ms by events, "
        f"{r['table']['graph_ms']:.4f} in a graph; plain {r['plain_ms']:.4f}"
        f" ms; bound {b:.4f} ms ({by}: {moved / 1e6:.2f} MB, "
        f"{flops / 1e6:.1f} MFLOP; FFT graph time "
        f"{100 * b / r['graph_ms']:.1f}% of it, table graph time "
        f"{100 * b / r['table']['graph_ms']:.1f}%); bound on a table DFT's "
        f"operations: {table_bound:.4f} ms; library: none")
    if not ok:
        raise AssertionError(f"fbank kernels disagree with plain: {r}")
    return r


def conv_library(x, w, b, conv, pt, pf, dtype):
    """The yardstick: F.conv2d on NCHW tensors of ``dtype`` (cuDNN) and
    F.max_pool2d.  The layout permutes run here, outside the timed call;
    returns the call and a function mapping its output to the port's
    [N, (ot', of', filter)] rows."""
    n, nf = x.shape[0], conv.num_filters
    xn = x.view(n, conv.in_t, conv.in_f, conv.in_c).permute(
        0, 3, 1, 2).contiguous().to(dtype)
    wn = w.view(nf, conv.filt_t, conv.filt_f, conv.in_c).permute(
        0, 3, 1, 2).contiguous().to(dtype)
    bn = b.to(dtype)
    return (lambda: nnf.max_pool2d(nnf.conv2d(xn, wn, bn), (pt, pf)),
            lambda y: y.permute(0, 2, 3, 1).reshape(n, -1).float())


def conv_case(name, cfg, rows, dev):
    """The wgmma kernel (bf16 operands) and the CUDA-core kernel (f32)
    against their plain versions and the cuDNN yardstick."""
    conv = Conv2DComponent(cfg.in_t, cfg.in_f, cfg.in_c, cfg.filt_t,
                           cfg.filt_f, cfg.num_filters, device=dev)
    conv.init(torch_generator(SEED, name))
    rng = np_rng(SEED, name)
    x = torch.as_tensor(rng.normal(size=(rows, conv.input_dim))
                        .astype(np.float32), device=dev)
    w, b = conv.w.detach(), conv.b.detach()
    pt, pf = cfg.pool_t, cfg.pool_f
    flops = 2 * rows * conv.num_patches * conv.patch_dim * conv.num_filters
    ref32 = conv2d_maxpool_reference(x, w, b, conv, pt, pf, bf16=False)
    out = {}
    for mode, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        bf16 = mode == "bf16"
        run = lambda: conv2d_maxpool(x, w, b, conv, pt, pf, bf16=bf16)
        got = run()
        ref = conv2d_maxpool_reference(x, w, b, conv, pt, pf, bf16=bf16)
        lib, lib_rows = conv_library(x, w, b, conv, pt, pf, dtype)
        lib_err = float((lib_rows(lib()) - ref).abs().max())
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        rel32 = float((got - ref32).abs().max() / ref32.abs().max())
        if bf16:
            ok = rel <= CONV_BF16_TOL and rel32 < CONV_BF16_REL
            limit = f"max err / max|ref| {CONV_BF16_TOL}"
        else:
            ok = bool(torch.allclose(got, ref, rtol=CONV_F32_TOL,
                                     atol=CONV_F32_TOL))
            limit = f"rtol=atol={CONV_F32_TOL}"
        r = {"name": f"{name} {mode}", "max_abs_err": err,
             "rel_err": rel, "rel_err_vs_f32": rel32,
             "shape": f"{rows} rows x {conv.input_dim} -> {got.shape[1]}",
             "ms": time_ms(run),
             "plain_ms": time_ms(lambda: conv2d_maxpool_reference(
                 x, w, b, conv, pt, pf, bf16=bf16)),
             "library_ms": time_ms(lib), "library_graph_ms": graph_ms(lib)}
        r["bound_ms"], r["bound_by"] = bound(
            nbytes(x, w, b, got), flops, mode)
        kernel = "wgmma" if bf16 else "CUDA cores"
        log(f"kernel conv_maxpool {name} {mode} ({kernel}): {r['shape']}: "
            f"max err vs plain {err:.3g} ({rel:.3g} of max|ref|; limit "
            f"{limit}), err vs f32 plain / max|ref| {rel32:.3g}; kernel "
            f"{r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.2f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f} ms, library (F.conv2d {mode} + "
            f"F.max_pool2d) {r['library_ms']:.4f} ms, graph "
            f"{r['library_graph_ms']:.4f} (max err vs plain "
            f"{lib_err:.3g}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it)")
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"conv kernel disagrees with plain: {r}")
        out[mode] = r
    return out


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and values, NaN matching NaN."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def maxpool_case(name, shape, rows, dtype, dev):
    """Kernel 3: the forward and the backward the wrappers pick
    (vectorised where the shape and alignment allow it), the scalar
    forward, with and without the argmax, and the scalar backward, against
    the plain versions and the library calls; returns the times and
    bandwidths."""
    pool = mp.Pool3D(*shape)
    rng = np_rng(SEED, f"maxpool {name}")
    in_dim = shape[0] * shape[1] * shape[2]
    x = torch.as_tensor(rng.normal(size=(rows, in_dim)).astype(np.float32),
                        device=dev).to(dtype)
    kind = mp.forward_kernel(pool, dtype, x.data_ptr())
    y = mp.maxpool3d(x, pool)
    y2, arg = mp.maxpool3d(x, pool, with_argmax=True)
    ys, args = mp.maxpool3d_scalar(x, pool, with_argmax=True)
    want, want_arg = mp.maxpool3d_reference(x, pool, with_argmax=True)
    d = torch.as_tensor(rng.normal(size=tuple(y.shape)).astype(np.float32),
                        device=dev).to(dtype)
    bwd_kind = mp.backward_kernel(pool, dtype, d.data_ptr(), arg.data_ptr())
    dx = mp.maxpool3d_backward(d, arg, pool)
    dxs = mp.maxpool3d_backward_scalar(d, arg, pool)
    want_dx = mp.maxpool3d_backward_reference(d, want_arg, pool)
    torch.cuda.synchronize()
    ok = (bit_equal(y, want) and bit_equal(y2, want) and bit_equal(ys, want)
          and torch.equal(arg, want_arg) and torch.equal(args, want_arg)
          and bit_equal(dx, want_dx) and bit_equal(dxs, want_dx))
    mode = "bf16" if dtype == torch.bfloat16 else "f32"
    fwd = lambda: mp.maxpool3d(x, pool)
    fwd_arg = lambda: mp.maxpool3d(x, pool, True)
    sc = lambda: mp.maxpool3d_scalar(x, pool)
    sc_arg = lambda: mp.maxpool3d_scalar(x, pool, True)
    bwd = lambda: mp.maxpool3d_backward(d, arg, pool)
    sc_bwd = lambda: mp.maxpool3d_backward_scalar(d, arg, pool)
    r = {"name": f"{name} {mode}", "kernel": kind, "bwd_kernel": bwd_kind,
         "max_abs_err": 0.0 if ok else float(
             (y.float() - want.float()).abs().max()),
         "fwd_ms": time_ms(fwd), "fwd_graph_ms": graph_ms(fwd),
         "fwd_plain_ms": time_ms(lambda: mp.maxpool3d_reference(x, pool)),
         "arg_ms": time_ms(fwd_arg), "arg_graph_ms": graph_ms(fwd_arg),
         "arg_plain_ms": time_ms(
             lambda: mp.maxpool3d_reference(x, pool, True)),
         "sc_fwd_ms": time_ms(sc), "sc_fwd_graph_ms": graph_ms(sc),
         "sc_arg_ms": time_ms(sc_arg), "sc_arg_graph_ms": graph_ms(sc_arg),
         "bwd_ms": time_ms(bwd), "bwd_graph_ms": graph_ms(bwd),
         "bwd_plain_ms": time_ms(
             lambda: mp.maxpool3d_backward_reference(d, arg, pool)),
         "sc_bwd_ms": time_ms(sc_bwd), "sc_bwd_graph_ms": graph_ms(sc_bwd),
         "bwd_host_us": host_us(bwd), "sc_bwd_host_us": host_us(sc_bwd)}
    for key in ("fwd", "arg", "bwd"):
        r[f"sc_{key}_plain_ms"] = r[f"{key}_plain_ms"]
    # yardsticks: amax over the window for the forward alone, and
    # max_pool3d with indices and its backward on the (t, f, c) volume
    it, i_f, ic, pt, pf, pc = shape
    x5 = x.view(rows, 1, it, i_f, ic)
    k = [pt, pf, pc]
    y5, idx = nnf.max_pool3d(x5, k, return_indices=True)
    d5 = d.view(y5.shape)
    libs = {"fwd": lambda: x.view(rows, it // pt, pt, i_f // pf, pf,
                                  ic // pc, pc).amax(dim=(2, 4, 6)),
            "arg": lambda: nnf.max_pool3d(x5, k, return_indices=True),
            "bwd": lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                d5, x5, k, k, [0, 0, 0], [1, 1, 1], False, idx)}
    for key, lib in libs.items():
        r[f"{key}_library_ms"] = time_ms(lib)
        r[f"{key}_library_graph_ms"] = graph_ms(lib)
    for key in ("fwd", "arg", "bwd"):
        r[f"sc_{key}_library_ms"] = r[f"{key}_library_ms"]
        r[f"sc_{key}_library_graph_ms"] = r[f"{key}_library_graph_ms"]
    xb, yb, ab = x.nbytes, y.nbytes, arg.nbytes
    r["fwd_bound_ms"] = r["sc_fwd_bound_ms"] = bound(xb + yb, 0, "f32")[0]
    r["arg_bound_ms"] = r["sc_arg_bound_ms"] = bound(xb + yb + ab, 0,
                                                     "f32")[0]
    r["bwd_bound_ms"] = r["sc_bwd_bound_ms"] = bound(yb + ab + xb, 0,
                                                     "f32")[0]
    gbs = lambda nbytes, ms: nbytes / ms / 1e6
    log(f"kernel maxpool {r['name']}: {rows} rows x {in_dim} -> "
        f"{y.shape[1]} (pool {pt}x{pf}x{pc}), {arg.dtype} argmax, "
        f"maxpool3d takes the {kind} kernel: bit-equal to plain: {ok}; "
        f"forward {r['fwd_ms']:.4f} ms, graph {r['fwd_graph_ms']:.4f} "
        f"({gbs(xb + yb, r['fwd_graph_ms']):.0f} GB/s, "
        f"{100 * r['fwd_bound_ms'] / r['fwd_graph_ms']:.1f}% of bound) vs "
        f"scalar {r['sc_fwd_ms']:.4f} / graph {r['sc_fwd_graph_ms']:.4f}, "
        f"plain {r['fwd_plain_ms']:.4f}, library (amax) "
        f"{r['fwd_library_ms']:.4f} / graph {r['fwd_library_graph_ms']:.4f}, "
        f"bound {r['fwd_bound_ms']:.4f}; with "
        f"argmax {r['arg_ms']:.4f} ms, graph {r['arg_graph_ms']:.4f} "
        f"({gbs(xb + yb + ab, r['arg_graph_ms']):.0f} GB/s) vs scalar "
        f"{r['sc_arg_ms']:.4f} / graph {r['sc_arg_graph_ms']:.4f}, plain "
        f"{r['arg_plain_ms']:.4f}, library (max_pool3d with indices) "
        f"{r['arg_library_ms']:.4f} / graph "
        f"{r['arg_library_graph_ms']:.4f}, bound {r['arg_bound_ms']:.4f}; "
        f"maxpool3d_backward takes the {bwd_kind} kernel: backward "
        f"{r['bwd_ms']:.4f} ms, graph {r['bwd_graph_ms']:.4f} "
        f"({gbs(yb + ab + xb, r['bwd_graph_ms']):.0f} GB/s, "
        f"{100 * r['bwd_bound_ms'] / r['bwd_graph_ms']:.1f}% of bound) vs "
        f"scalar {r['sc_bwd_ms']:.4f} / graph {r['sc_bwd_graph_ms']:.4f} "
        f"({100 * r['bwd_bound_ms'] / r['sc_bwd_graph_ms']:.1f}%), wrapper "
        f"host {r['bwd_host_us']:.1f} / scalar {r['sc_bwd_host_us']:.1f} us "
        f"a call, plain "
        f"{r['bwd_plain_ms']:.4f}, library (max_pool3d_with_indices_"
        f"backward) {r['bwd_library_ms']:.4f} / graph "
        f"{r['bwd_library_graph_ms']:.4f}, bound "
        f"{r['bwd_bound_ms']:.4f} (bytes)")
    if not ok:
        raise AssertionError(f"maxpool kernels disagree with plain: {r}")
    return r


@contextlib.contextmanager
def recorded_train_steps():
    """Collect the objf (a device scalar) of every step of every
    Nnet.train_steps group (the trainer's only way to a step)."""
    objfs = []
    steps = Nnet.train_steps

    def recording(self, *args, **kwargs):
        opt, objf = steps(self, *args, **kwargs)
        objfs.extend(objf)
        return opt, objf

    Nnet.train_steps = recording
    try:
        yield objfs
    finally:
        Nnet.train_steps = steps


@contextlib.contextmanager
def eager_training():
    """Nnet.train_steps as its plain version, the eager loop of
    train_step on the net's device (there is no public switch)."""
    steps = Nnet.train_steps
    Nnet.train_steps = Nnet._train_steps_eager
    try:
        yield
    finally:
        Nnet.train_steps = steps


@contextlib.contextmanager
def counted_eager_steps():
    """Counts calls of the eager loop: a graphed run makes none."""
    calls = []
    eager = Nnet._train_steps_eager

    def counting(self, *args, **kwargs):
        calls.append(1)
        return eager(self, *args, **kwargs)

    Nnet._train_steps_eager = counting
    try:
        yield calls
    finally:
        Nnet._train_steps_eager = eager


def captures(net: Nnet) -> str:
    """The train-step graphs ``net`` captured, and their seconds."""
    cs = net.capture_seconds
    steps = [k for k in cs if k[0] == "step"]
    return (f"{len(steps)} step graphs ({sum(k[4] for k in steps)} with a "
            f"refresh), {len(cs) - len(steps)} tail graphs, "
            f"{sum(cs.values()):.3f} s of captures")


def train_slice(vols, ali, t2p, num_pdfs, device, ckpt_dir):
    """wsj.train on ``device``: (AmNnet, seconds, per-step objfs,
    pre-combine params, their NG states)."""
    if device != "cpu":
        torch.cuda.synchronize()
    t = time.perf_counter()
    with recorded_train_steps() as objfs:
        am = wsj.train(vols, ali, t2p, num_pdfs, num_epochs=TRAIN_EPOCHS,
                       seed=SEED, device=device, checkpoint_dir=ckpt_dir)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    last, ng, _ = load_checkpoint(
        os.path.join(ckpt_dir, f"epoch{TRAIN_EPOCHS - 1}.npz"),
        params_to_numpy(am.nnet), opt_to_numpy(am.nnet.init_opt()))
    return am, secs, torch.stack(objfs).cpu().numpy(), last, ng


def leaves(tree) -> list:
    """The arrays of a params or NG-state tree, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def train_bit_check(tvols, ali, t2p, num_pdfs, dev, tmp):
    """Phase 5b: the training slice on the card twice under deterministic
    cuDNN, through the graphs and through the eager loop: every step's
    objf, the pre-combine parameters and NG states, the final parameters
    must be equal, bit for bit, and the maxpool launches of the replays
    (the graphed run's less its warm-ups') the eager run's."""
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("graphed", "eager"):
            reset_launches()
            ctx = (eager_training() if mode == "eager"
                   else contextlib.nullcontext())
            with counted_eager_steps() as eager_calls, ctx:
                am, secs, objfs, last, ng = train_slice(
                    tvols, ali, t2p, num_pdfs, dev,
                    os.path.join(tmp, f"bits_{mode}"))
            runs[mode] = dict(
                secs=secs, objfs=objfs, eager_calls=len(eager_calls),
                pre=leaves(last) + leaves(ng),
                final=[p.detach().cpu().numpy()
                       for p in am.nnet.parameters()],
                launches=(mp.maxpool3d.launches
                          - mp.maxpool3d.warmup_launches,
                          mp.maxpool3d_backward.launches
                          - mp.maxpool3d_backward.warmup_launches),
                warmups=(mp.maxpool3d.warmup_launches,
                         mp.maxpool3d_backward.warmup_launches))
    finally:
        torch.backends.cudnn.deterministic = False
    g, e = runs["graphed"], runs["eager"]
    same = {
        "objfs": g["objfs"].tobytes() == e["objfs"].tobytes(),
        "pre-combine params and NG states": all(
            a.tobytes() == b.tobytes() for a, b in zip(g["pre"], e["pre"])),
        "final params": all(a.tobytes() == b.tobytes()
                            for a, b in zip(g["final"], e["final"])),
        "maxpool launches": g["launches"] == e["launches"]
        and e["warmups"] == (0, 0)}
    log(f"train graphed vs eager (deterministic cuDNN, {len(g['objfs'])} "
        f"steps): bit-equal {same}; maxpool fwd/bwd launches graphed "
        f"{g['launches']} replayed + {g['warmups']} in warm-ups, eager "
        f"{e['launches']}; eager-loop calls in the "
        f"graphed run {g['eager_calls']}; wsj.train {g['secs']:.3f} s "
        f"graphed (captures included), {e['secs']:.3f} s eager")
    if not all(same.values()) or g["eager_calls"] or not e["eager_calls"]:
        raise AssertionError("the graphed training is not the eager "
                             "training bit for bit")


def valid_logprob(net: Nnet, valid) -> float:
    dev = net.device
    return float(net.objf(torch.as_tensor(valid.x, device=dev),
                          torch.as_tensor(valid.y, device=dev)))


def busy_ms(run) -> float:
    """Device busy time of ``run()`` (the union of the kernels' intervals
    in a torch.profiler trace), in ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no kernel on the card")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def train_step_ms(net, rows, dev, seed_tag):
    """ms a step of ``net`` at ``rows`` rows, in groups of 8 on random
    inputs from a seed, eager (the PR 14 loop) and graphed: in the NG
    warm-up (every step refreshes its states: 8 eighs at the WSJ CNN)
    and in the steady state (one refresh in 16 steps), after each key's
    capture; the captures' seconds; and the device's busy share of the
    steady steps, eager and graphed."""
    d, k = net.input_dim, 8
    rng = np_rng(SEED, seed_tag)
    xs = [rng.normal(size=(rows, d)).astype(np.float32) for _ in range(k)]
    ys = [rng.integers(0, net.output_dim, rows) for _ in range(k)]
    ws = [np.ones(rows, np.float32) for _ in range(k)]
    out = {}
    for mode in ("eager", "graphed"):
        fn = net._train_steps_eager if mode == "eager" else net.train_steps
        opt = net.init_opt()

        def group(t0):
            nonlocal opt
            opt = with_states(opt, [s._replace(t=t0)
                                    for _, s in ng_states(opt)])
            opt = fn(opt, xs, ys, 0.001, weights=ws)[0]

        for phase, t0s in (("warmup", (0, 8, 16)),
                           ("steady", (64, 72, 80, 88))):
            for t0 in t0s[:2]:          # each key's capture
                group(t0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                for t0 in t0s:
                    group(t0)
            torch.cuda.synchronize()
            out[f"{mode}_{phase}_ms"] = (
                1e3 * (time.perf_counter() - t) / (3 * k * len(t0s)))
        busy = busy_ms(lambda: [group(t0) for t0 in (64, 72, 80, 88)])
        out[f"{mode}_steady_busy"] = (busy / (4 * k)
                                      / out[f"{mode}_steady_ms"])
    out["captures"] = captures(net)
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


@contextlib.contextmanager
def lattice_probes(recipe=wsj):
    """Times the lattice path's stages (synchronising the card around
    each) and counts their calls, and records the loglikes
    decode_utterances is given, each decode_batch_lattice call's
    (overflow, capacity) and its decoder's graph capture seconds, and
    the calls of the eager frame loop and backtrace.  Wraps the
    functions where the path looks them up (in ``recipe``'s module: wsj
    or swbd; None leaves decode_utterances and score_sweep alone);
    restores them on exit."""
    secs = dict.fromkeys(("decode_utterances", "frame loop", "fetch",
                          "assembly + prune", "determinize", "score_sweep"),
                         0.0)
    probe = {"s": secs, "loglikes": {}, "overflow": []}
    probe["calls"] = dict.fromkeys(secs, 0)
    probe["captures"] = {}       # id(decoder) -> its capture seconds
    probe["eager"] = 0
    targets = [
        (TopKDecoder, "_decode", "frame loop", None),
        (TopKDecoder, "_fetch_lattice_run", "fetch", None),
        (TopKDecoder, "_assemble_lattice", "assembly + prune", None),
        (topk_decoder, "determinize_lattice", "determinize", None),
        (TopKDecoder, "decode_batch_lattice", None,
         lambda a, out: (probe["overflow"].append(
             (a[0].last_overflow, a[0].A_lat)),
             probe["captures"].__setitem__(id(a[0]),
                                           a[0].capture_seconds)))]
    if recipe is not None:
        targets += [
            (recipe, "decode_utterances", "decode_utterances",
             lambda a, out: probe["loglikes"].update(a[1])),
            (recipe, "score_sweep", "score_sweep", None)]
    # the eager frame loop and backtrace: a captured search calls neither
    for name in ("_run_frames_eager", "_bt_walk_eager"):
        targets.append((TopKDecoder, name, None, lambda a, out: probe.update(
            eager=probe["eager"] + 1)))

    def wrap(fn, key, after):
        @functools.wraps(fn)
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            if key:
                secs[key] += time.perf_counter() - t
                probe["calls"][key] += 1
            if after:
                after(a, out)
            return out
        return run

    saved = [(owner, name, getattr(owner, name))
             for owner, name, _, _ in targets]
    try:
        for owner, name, key, after in targets:
            setattr(owner, name, wrap(getattr(owner, name), key, after))
        yield probe
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def eager_search():
    """The batch search eagerly on the card: TopKDecoder's frame loop and
    best-path backtrace through their private eager methods instead of
    the captured graphs (there is no public switch); restored on exit."""
    saved = TopKDecoder._run_frames, TopKDecoder._bt_walk
    TopKDecoder._run_frames = lambda self, *a: self._run_frames_eager(*a)
    TopKDecoder._bt_walk = lambda self, *a: self._bt_walk_eager(*a)
    try:
        yield
    finally:
        TopKDecoder._run_frames, TopKDecoder._bt_walk = saved


def cost_bits(c: float) -> int:
    return int(np.float32(c).view(np.int32))


def best_path_runs(dec, lls):
    """``dec.decode_batch(lls)`` on the card with the captured search and
    with the eager one, and the host ``_best_path`` on the fetched
    histories.  Returns the seconds of each and the rows where the
    eager search or the host walk differs from the captured (tids,
    words, cost bits), and the captured paths."""
    out, secs = {}, {}
    for name in ("captured", "eager"):
        with eager_search() if name == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[name] = dec.decode_batch(lls)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
    out["host"] = host_best_paths(dec, lls)
    bad = {name: differing(out["captured"], out[name])
           for name in ("eager", "host")}
    return secs, bad, out["captured"]


def host_best_paths(dec, lls):
    """The host ``_best_path`` of each row on the best-path histories of
    ``lls`` decoded on the card and fetched whole."""
    am, lengths = dec._pad(lls)
    lv = dec._decode(torch.as_tensor(am, device=dec.device))["lv"]
    h = lv.cpu().numpy()
    r = {k: h[:, i].transpose(1, 0, 2)
         for i, k in enumerate(("fs", "fc", "bp_arc", "bp_prev"))}
    r["fc"] = r["fc"].view(np.float32)
    return [dec._best_path(r, am, int(n), b) for b, n in enumerate(lengths)]


def differing(paths, others):
    """Rows whose (tids, words, cost bits) differ."""
    key = lambda p: (list(p[0]), list(p[1]), cost_bits(p[2]))
    return [b for b, (x, y) in enumerate(zip(paths, others, strict=True))
            if key(x) != key(y)]


def search_line(name, sec, calls, caps, peak):
    """One run's split of a lattice decode, for the log; ``caps`` are the
    capture seconds of each decoder (the captures run inside the frame
    loop's first calls)."""
    cap = sum(sum(c.values()) for c in caps)
    return (f"{name}: frame loop {sec['frame loop']:.3f} s "
            f"({calls['frame loop']} batches; "
            f"{sec['frame loop'] - cap:.3f} s without the captures), "
            f"fetch {sec['fetch']:.3f}, assembly + prune "
            f"{sec['assembly + prune']:.3f} ({calls['assembly + prune']} "
            f"lattices), determinize {sec['determinize']:.3f} "
            f"({calls['determinize']}); graph captures {cap:.3f} s; peak "
            f"max_memory_allocated {peak / 2**20:.1f} MiB")


def one_best(lats):
    """utt -> (words, cost) of each lattice's best path at the recipe's
    acoustic scale."""
    out = {}
    for u, lat in lats.items():
        _, w, c = shortest_path(lat, acoustic_scale=wsj.ACOUSTIC_SCALE)
        out[u] = (w.tolist(), c)
    return out


def lattice_slice(am, am_cpu, corpus, hclg, word_table, dec):
    """Phase 4: wsj.decode_and_score on the card (dev and test halves of
    the corpus), held against the host lattice decoder and ``dec``'s best
    path on the same loglikes, and replayed on the CPU."""
    dev_c, test_c = corpus.split(0.5)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with lattice_probes() as probe:
        t = time.perf_counter()
        res = wsj.decode_and_score(am, dev_c, test_c, hclg, word_table,
                                   seed=SEED)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches = {"fbank_fft": fbank_frames.launches,
                "conv_maxpool": conv2d_maxpool.launches}
    lats, lls = res["lattices"], probe["loglikes"]
    best = one_best(lats)
    ns = [lat.num_states for lat in lats.values()]
    na = [lat.num_arcs for lat in lats.values()]
    sec = probe["s"]
    log(f"lattice slice: {len(lats)} utterances ({len(dev_c.waves)} dev, "
        f"{len(test_c.waves)} test), launches {launches}, "
        f"decode_batch_lattice calls {len(probe['overflow'])}, (overflow, "
        f"A_lat) {sorted(set(probe['overflow']))}; determinized lattices: "
        f"states {sum(ns)} total / {max(ns)} largest, arcs {sum(na)} total "
        f"/ {max(na)} largest; wsj.decode_and_score {total_s:.3f} s: "
        f"decode_utterances {sec['decode_utterances']:.3f} s (frame loop "
        f"{sec['frame loop']:.3f}, fetch {sec['fetch']:.3f}, assembly + "
        f"prune {sec['assembly + prune']:.3f}, determinize "
        f"{sec['determinize']:.3f}), score_sweep {sec['score_sweep']:.3f} "
        f"s; dev WER {res['dev_wer']:.2f}% at {res['point']}, test WER "
        f"{res['wer']:.2f}% ({res['errors']} errors / {res['words']} words; "
        f"random weights, not asserted)")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the lattice slice: "
                             f"{launches}")
    if sorted(lats) != sorted(corpus.waves) or sorted(lls) != sorted(lats):
        raise AssertionError("the lattice slice lost utterances")
    if any(ov != (0, 0) for ov, _ in probe["overflow"]):
        raise AssertionError(f"lattice overflow: {probe['overflow']}")

    # the same two decode_utterances calls with the eager search
    halves = [{u: lls[u] for u in c.waves} for c in (dev_c, test_c)]
    torch.cuda.reset_peak_memory_stats()
    with lattice_probes(None) as eprobe, eager_search():
        t = time.perf_counter()
        eager = {}
        for half in halves:
            eager.update(topk_decoder.decode_utterances(
                hclg, half, acoustic_scale=wsj.ACOUSTIC_SCALE, beam=60.0,
                lattice_beam=8.0, max_active=2000, device=am.nnet.device))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t
    peak_e = torch.cuda.max_memory_allocated()
    audio_s = sum(len(v) for v in lls.values()) / 100.0
    same_lats = lattices_equal(lats, eager)
    n_cap = sum(len(c) for c in probe["captures"].values())
    log(f"lattice search on the card, captured vs eager ({len(lats)} "
        f"utterances, {audio_s:.2f} s of audio, the dev and test "
        f"decode_utterances calls): decode_utterances "
        f"{sec['decode_utterances']:.3f} s (RTF "
        f"{sec['decode_utterances'] / audio_s:.4f}) vs {eager_s:.3f} s "
        f"(RTF {eager_s / audio_s:.4f}); "
        + search_line("captured", sec, probe["calls"],
                      probe["captures"].values(), peak)
        + f" ({n_cap} graphs: "
        + "; ".join(", ".join(f"{k[1:]} {v:.3f}" for k, v in c.items())
                    for c in probe["captures"].values())
        + "); " + search_line("eager", eprobe["s"], eprobe["calls"], [],
                              peak_e)
        + f"; lattices equal arc for arc: {same_lats}; eager frame-loop "
        f"and backtrace calls in the captured run {probe['eager']}, in "
        f"the eager run {eprobe['eager']}; eager (overflow, A_lat) "
        f"{sorted(set(eprobe['overflow']))}")
    if not same_lats or probe["eager"] or not eprobe["eager"] or any(
            ov != (0, 0) for ov, _ in eprobe["overflow"]):
        raise AssertionError("the captured and eager lattice searches "
                             "disagree")
    if (probe["calls"]["assembly + prune"] != len(lats)
            or eprobe["calls"]["assembly + prune"] != len(lats)
            or probe["calls"]["determinize"] != len(lats)):
        raise AssertionError("a padded row was assembled or determinized")

    # the host lattice decoder and the best-path search on the same
    # loglikes: K = min(2000, states) covers every state, so all three
    # are exact Viterbi
    t = time.perf_counter()
    host = one_best({u: lattice_decode(
        hclg, ll, acoustic_scale=wsj.ACOUSTIC_SCALE, beam=60.0,
        lattice_beam=8.0, max_active=2000) for u, ll in lls.items()})
    host_s = time.perf_counter() - t
    utts = sorted(lls)
    bsecs, bt_bad, paths = best_path_runs(dec, [lls[u] for u in utts])
    batch_s = bsecs["captured"]
    log(f"best path on the card ({len(utts)} utterances in one batch, "
        f"warm graphs): captured {bsecs['captured']:.3f} s (RTF "
        f"{bsecs['captured'] / audio_s:.4f}), eager {bsecs['eager']:.3f} s "
        f"(RTF {bsecs['eager'] / audio_s:.4f}); rows where the eager "
        f"search differs (tids, words, cost bits) {bt_bad['eager']}, where "
        f"the host _best_path on the fetched histories differs from the "
        f"device backtrace {bt_bad['host']}; graphs "
        f"{len(dec.capture_seconds)} "
        f"({sum(dec.capture_seconds.values()):.3f} s of captures)")
    if bt_bad["eager"] or bt_bad["host"]:
        raise AssertionError("the captured best path disagrees with the "
                             "eager search or the host backtrace")
    bad_host = [u for u in utts if best[u][0] != host[u][0] or abs(
        best[u][1] - host[u][1]) > LAT_COST_ABS + LAT_COST_REL * abs(
            host[u][1])]
    bad_path = [u for u, (_, w, _) in zip(utts, paths)
                if best[u][0] != w.tolist()]
    log(f"lattice vs host lattice_decode ({host_s:.1f} s, same loglikes, "
        f"beam 60, lattice beam 8): one-best words and costs (limit rel "
        f"{LAT_COST_REL} / abs {LAT_COST_ABS}) differ on {bad_host}; vs "
        f"decode_batch best path (warm, {batch_s:.3f} s for the "
        f"{len(utts)} utterances in one batch) words differ on {bad_path}")
    if bad_host or bad_path:
        raise AssertionError("the lattice one-best disagrees with the host "
                             "lattice decoder or the best-path search")

    t = time.perf_counter()
    res_c = wsj.decode_and_score(am_cpu, dev_c, test_c, hclg, word_table,
                                 seed=SEED)
    cpu_s = time.perf_counter() - t
    best_c = one_best(res_c["lattices"])
    same = all(best[u][0] == best_c[u][0] for u in utts)
    log(f"lattice replay on cpu ({cpu_s:.1f} s): one-best words equal: "
        f"{same}, test hyps at the point equal: "
        f"{res_c['hyps'] == res['hyps']}; point {res_c['point']} vs "
        f"{res['point']}, dev WER "
        f"{res_c['dev_wer']:.2f}% vs {res['dev_wer']:.2f}%, test WER "
        f"{res_c['wer']:.2f}% vs {res['wer']:.2f}%")
    if not same or any(res_c[k] != res[k]
                       for k in ("point", "dev_wer", "wer")):
        raise AssertionError("the card's lattice slice disagrees with the "
                             "CPU replay")


def mfcc_check(corpus, dev) -> float:
    """One utterance's MFCC through the kernel on the card against
    mfcc_reference on the CPU, on the same dither noise (the recipe's
    options and the stage of utterance 0); returns the largest error
    relative to each column's limit (must be <= 1)."""
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 1.0
    wave = corpus.waves[sorted(corpus.waves)[0]]
    gen = lambda: torch_generator(SEED, "mfcc_dither", 0)
    card = fbank_ops.mfcc(torch.as_tensor(wave, device=dev), opts, gen())
    cpu = fbank_ops.mfcc_reference(torch.as_tensor(wave), opts, gen())
    err = (card.cpu().double() - cpu.double()).abs().amax(dim=0).numpy()
    limit = MFCC_REL * F.lifter_coeffs(opts.num_ceps,
                                       opts.cepstral_lifter).astype(float)
    limit[0] = MFCC_ENERGY_ATOL
    worst = float((err / limit).max())
    log(f"mfcc card vs cpu: {tuple(card.shape)} (23 bins + energy, 13 "
        f"cepstra, dither 1 from the same generator), max |err| energy "
        f"{err[0]:.3g} (limit {MFCC_ENERGY_ATOL}), cepstra "
        f"{err[1:].max():.3g}; worst err / limit {worst:.3g}")
    if card.shape != cpu.shape or not bool(torch.isfinite(card).all()) \
            or worst > 1.0:
        raise AssertionError("the card's MFCC disagrees with the plain "
                             "version on the CPU")
    return worst


def reset_launches() -> None:
    for fn in common.COUNTED:
        fn.launches = fn.warmup_launches = 0


def read_launches() -> dict:
    return {"fbank_fft": fbank_frames.launches,
            "fbank_fft_mixed": fbank_ops.fbank_frames_mixed.launches,
            "fbank_table": fbank_ops.fbank_frames_table.launches,
            "conv_maxpool": conv2d_maxpool.launches,
            "conv_maxpool_f32": conv2d_maxpool_f32.launches,
            "maxpool_fwd_vec": mp.maxpool3d.launches,
            "maxpool_fwd_scalar": mp.maxpool3d_scalar.launches,
            "maxpool_bwd": mp.maxpool3d_backward.launches,
            "maxpool_bwd_scalar": mp.maxpool3d_backward_scalar.launches}


def read_warmups() -> dict:
    """The maxpool kernels' launches in CUDA graphs' warm-ups (real
    launches, also in ``read_launches``; an eager run makes none)."""
    return {"maxpool_fwd_vec": mp.maxpool3d.warmup_launches,
            "maxpool_fwd_scalar": mp.maxpool3d_scalar.warmup_launches,
            "maxpool_bwd": mp.maxpool3d_backward.warmup_launches,
            "maxpool_bwd_scalar":
                mp.maxpool3d_backward_scalar.warmup_launches}


@contextlib.contextmanager
def launches_per_call(owner, name, calls):
    """Wraps ``owner.name`` where the recipe looks it up: each call appends
    (its arguments, the kernels' launches during it, its result) to
    ``calls``.  Restores it on exit."""
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def run(*a, **k):
        before = read_launches()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        after = read_launches()
        calls.append((a, {n: after[n] - before[n] for n in after}, out))
        return out

    setattr(owner, name, run)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def timed_fits(owner, calls):
    """Wraps ``owner.fit`` (``wsj.fit`` where the recipe looks it up):
    each call appends (its arguments, its seconds, the kernels' launches
    during it, the eager-loop calls during it, the maxpool launches in
    graph warm-ups during it) to ``calls``."""
    fit = owner.fit

    @functools.wraps(fit)
    def run(*a, **k):
        before, warm = read_launches(), read_warmups()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counted_eager_steps() as eager:
            out = fit(*a, **k)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after, warm_after = read_launches(), read_warmups()
        calls.append((a, secs, {n: after[n] - before[n] for n in after},
                      len(eager),
                      {n: warm_after[n] - warm[n] for n in warm}))
        return out

    return mock_attr(owner, "fit", run)


@contextlib.contextmanager
def mock_attr(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def eager_refit(call):
    """A recorded ``wsj.fit`` call again on a copy of its net (train_nnet
    initializes it from the seed), through the eager loop: (seconds,
    launches)."""
    net, *rest = call[0]
    net = copy.deepcopy(net)
    before = read_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with eager_training():
        wsj.fit(net, *rest[:4])         # no checkpoint_dir: the run's stay
    torch.cuda.synchronize()
    after = read_launches()
    return (time.perf_counter() - t,
            {n: after[n] - before[n] for n in after})


def recipe_phase(dev, tmp, corpus):
    """Phase 8: wsj.run on ``corpus`` on the card, eval_dnn on; then the
    CNN's training again through the eager loop (seconds and maxpool
    launches against the graphed run's); returns (launches in the run, of
    which the "mfcc" stage's fbank launches, the result)."""
    feats, fits = [], []
    reset_launches()
    with launches_per_call(wsj, "compute_features", feats), \
            timed_fits(wsj, fits), lattice_probes() as probe:
        t = time.perf_counter()
        res = wsj.run(corpus=corpus, nnet_epochs=RECIPE_EPOCHS,
                      eval_dnn=True, seed=SEED, device=dev,
                      exp_dir=os.path.join(tmp, "wsj"))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    launches = read_launches()
    cnn = [c for c in fits if any(isinstance(m, C.Maxpooling3DComponent)
                                  for m in c[0][0].modules())]
    if len(cnn) != 1 or len(fits) != 2 or any(c[3] for c in fits):
        raise AssertionError(f"the recipe's training ran other than two "
                             f"graphed fits with one CNN: {fits}")
    eager_s, eager_n = eager_refit(cnn[0])
    graphed_n, warm_n = cnn[0][2], cnn[0][4]
    mp_keys = ("maxpool_fwd_vec", "maxpool_bwd", "maxpool_fwd_scalar",
               "maxpool_bwd_scalar")
    log(f"recipe nnet_train: CNN {cnn[0][1]:.3f} s through the graphs "
        f"({captures(cnn[0][0][0])}; DNN "
        f"{[c[1] for c in fits if c is not cnn[0]][0]:.3f} s), the "
        f"same CNN fit eagerly {eager_s:.3f} s; maxpool launches graphed "
        f"{ {k: graphed_n[k] for k in mp_keys} }, of them in the graphs' "
        f"warm-ups {warm_n}, eager { {k: eager_n[k] for k in mp_keys} }")
    if any(graphed_n[k] - warm_n[k] != eager_n[k] for k in mp_keys):
        raise AssertionError("the graphed training's maxpool launches "
                             "(less its warm-ups') differ from the eager "
                             "training's")
    mfcc_launches = [n["fbank_fft"] for _, n, _ in feats]
    sec = probe["s"]
    K = min(2000, res["graph_states"])
    log(f"recipe: wsj.run({RECIPE_UTTS} utterances, {RECIPE_EPOCHS} epochs, "
        f"F = 64, eval_dnn) {total_s:.3f} s; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
        + f"; MFCC fbank launches {mfcc_launches}; run launches {launches}; "
        f"triphone tree {res['tree_leaves']} leaves, HCLG "
        f"{res['graph_states']} states, K {K}; decode_batch_lattice calls "
        f"{len(probe['overflow'])}, (overflow, A_lat) "
        f"{sorted(set(probe['overflow']))}; lattice stages (CNN + DNN): "
        f"frame loop {sec['frame loop']:.3f} s, fetch {sec['fetch']:.3f}, "
        f"assembly + prune {sec['assembly + prune']:.3f}, determinize "
        f"{sec['determinize']:.3f}, score_sweep {sec['score_sweep']:.3f}; "
        f"train {res['train_audio_ss']:.1f} audio-s/s, decode RTF "
        f"{res['decode_rtf']:.3f}; CNN dev WER {res['dev_wer']:.2f}% test "
        f"WER {res['wer']:.2f}% ({res['errors']} errors / {res['words']} "
        f"words), valid logprob {res['valid_logprob']:.4f}; DNN dev WER "
        f"{res['dnn_dev_wer']:.2f}% test WER {res['dnn_wer']:.2f}%, valid "
        f"logprob {res['dnn_valid_logprob']:.4f}; sign test: CNN better on "
        f"{res['cnn_better_utts']} utterances, DNN on "
        f"{res['dnn_better_utts']}, p = {res['cnn_vs_dnn_p']:.4g} (WERs "
        f"of {RECIPE_EPOCHS} epochs, not asserted)")
    if len(mfcc_launches) != 1 or mfcc_launches[0] <= 0:
        raise AssertionError(f"the fbank kernel did not run in the mfcc "
                             f"stage: {mfcc_launches}")
    need = ("fbank_fft", "conv_maxpool", "maxpool_fwd_vec", "maxpool_bwd")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"a kernel did not run in the recipe: "
                             f"{launches}")
    if not probe["overflow"] or any(ov != (0, 0)
                                    for ov, _ in probe["overflow"]):
        raise AssertionError(f"lattice overflow: {probe['overflow']}")
    if not (res["words"] > 0 and res["missing_utts"] == 0
            and np.isfinite([res["valid_logprob"],
                             res["dnn_valid_logprob"]]).all()):
        raise AssertionError(f"the recipe's result is malformed: {res}")
    return launches, mfcc_launches[0], res


def stream_utterance(wave, rate, am, stream, secs, chunk_frames=None):
    """One utterance through an OnlineRecognizer on ``am``'s device (fbank
    36 bins + deltas, CMVN frozen at zeros, +-5 splice with the rows
    reordered (t, c, f) -> (t, f, c) for the Conv2D), fed STREAM_CHUNK_S
    chunks, one piece of the chunk's frame count a chunk (as the verb
    does) unless ``chunk_frames`` is given.  Returns (tids, words, cost, the rows the decoder received,
    the ms of each accept_waveform call, the largest traceback window)."""
    dev = am.nnet.device
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = float(rate)
    opts.frame_opts.dither = 0.0
    opts.mel_opts.num_bins = 36
    cmvn = OnlineCmvn()
    cmvn.freeze(np.zeros(36, np.float32))
    pipe = OnlineFeaturePipeline("fbank", opts, cmvn=cmvn, device=dev)
    conv = am.nnet.components[0]

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            secs[key] += time.perf_counter() - t
            return out
        setattr(owner, name, run)

    timed(pipe.base, "accept_waveform", "base features")
    timed(pipe, "get_frames", "cmvn + deltas")

    def scorer(rows):
        t = time.perf_counter()
        v = rows.reshape(len(rows), conv.in_t, conv.in_c, conv.in_f)
        out = am.loglikes(v.transpose(0, 1, 3, 2).reshape(len(rows), -1))
        secs["am"] += time.perf_counter() - t
        return out

    stream.reset()
    rec_dec = AdvanceRecorder(stream)
    timed(rec_dec, "advance", "search")
    timed(rec_dec, "finalize", "search")
    chunk = max(1, int(STREAM_CHUNK_S * rate))
    rec = OnlineRecognizer(None, StreamingSplicer(scorer, wsj.CONTEXT,
                                                  wsj.CONTEXT),
                           pipeline=pipe, decoder=rec_dec,
                           chunk_frames=chunk_frames
                           or chunk // opts.frame_opts.window_shift)
    call_ms, window = [], 0
    for i in range(0, len(wave), chunk):
        t = time.perf_counter()
        rec.accept_waveform(wave[i:i + chunk])
        call_ms.append(1e3 * (time.perf_counter() - t))
        window = max(window, len(stream._buf))
    rec.input_finished()
    tids, words, cost = rec.result()
    return tids, words, cost, np.concatenate(rec_dec.rows), call_ms, window


def offline_loglikes(wave, rate, am):
    """The streaming pipeline finished in one call, spliced offline
    (wsj.splice_volume on (t, f, c) volumes) and scored."""
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = float(rate)
    opts.frame_opts.dither = 0.0
    opts.mel_opts.num_bins = 36
    cmvn = OnlineCmvn()
    cmvn.freeze(np.zeros(36, np.float32))
    pipe = OnlineFeaturePipeline("fbank", opts, cmvn=cmvn,
                                 device=am.nnet.device)
    pipe.accept_waveform(wave)
    pipe.finish()
    f = pipe.get_frames(0, pipe.num_frames_ready())
    v = f.reshape(len(f), 3, 36).transpose(0, 2, 1)
    return am.loglikes(wsj.splice_volume(v, wsj.CONTEXT, wsj.CONTEXT))


def load_stage(exp_dir, name):
    """A stage pickle of phase 8's wsj.run."""
    (path,) = glob.glob(os.path.join(exp_dir, f"stage*_{name}.pkl"))
    with open(path, "rb") as f:
        return pickle.load(f)


def phase8_model(dev, exp_dir, test):
    """Phase 8's artifacts for decoding ``test``: (the triphone Lang, its
    GMM, the unigram HCLG as an Fst and compiled, the CNN's AmNnet on
    ``dev``)."""
    am_gmm, _, tri = load_stage(exp_dir, "gmm_bootstrap")
    egs_train, _ = wsj.split_valid(load_stage(exp_dir, "egs"))
    t2p = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    hclg_fst = make_hclg_from_arpa(tri, make_unigram_arpa(test.word_probs))
    hclg = CompiledGraph(hclg_fst, t2p)
    net = make_convnet(wsj.model_config(36, num_pdfs), fused=True,
                       device=dev)
    params_from_jax(net, load_stage(exp_dir, "nnet_train"))
    am = wsj.acoustic_model(net, egs_train, num_pdfs)
    return tri, am_gmm, hclg_fst, hclg, am


def streaming_model(dev, exp_dir, test):
    """``phase8_model`` and a StreamingDecoder over TopKDecoder(beam 60,
    max_active 2000) on ``dev``."""
    tri, am_gmm, hclg_fst, hclg, am = phase8_model(dev, exp_dir, test)
    stream = StreamingDecoder(TopKDecoder(
        hclg, beam=60.0, max_active=2000, acoustic_scale=wsj.ACOUSTIC_SCALE,
        device=dev))
    return tri, am_gmm, hclg_fst, hclg, am, stream


def streaming_phase(dev, exp_dir, tmp, test):
    """Phase 9: the streaming path on phase 8's artifacts and its test
    split ``test``; returns the kernels' launches of each run: the
    recognizer ("streaming") and the verb on the card and with the host
    search ("verb_card", "verb_host")."""
    rate = test.sample_rate
    tri, am_gmm, hclg_fst, hclg, am, stream = streaming_model(dev, exp_dir,
                                                              test)
    num_pdfs = tri.trans_model.num_pdfs
    utts = sorted(test.waves)

    # ---- the Python API on the card -----------------------------------
    reset_launches()
    secs = dict.fromkeys(("base features", "cmvn + deltas", "am", "search"),
                         0.0)
    out, call_ms, window = {}, [], 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for u in utts:
        *res, rows, ms, win = stream_utterance(test.waves[u], rate, am,
                                               stream, secs)
        out[u] = (*res, rows)
        call_ms += ms
        window = max(window, win)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    audio_s = sum(len(test.waves[u]) for u in utts) / rate
    frames = sum(len(out[u][3]) for u in utts)
    bad_batch, ll_err = [], 0.0
    for u, (tids, words, cost, rows) in out.items():
        ((bt, bw, bc),) = stream.dec.decode_batch([rows])
        if (list(bt) != list(tids) or list(bw) != list(words)
                or abs(bc - cost) > STREAM_COST_ABS):
            bad_batch.append(u)
        off = offline_loglikes(test.waves[u], rate, am)
        ll_err = max(ll_err, float(np.abs(off - rows).max())
                     if off.shape == rows.shape else np.inf)
    hyps = {u: [tri.word_table.sym(int(w)) for w in out[u][1]] for u in utts}
    res = wer_details(test.transcripts, hyps)
    host = secs["base features"] + secs["cmvn + deltas"]
    log(f"streaming: {len(utts)} test utterances of phase 8 ({audio_s:.2f} s "
        f"of audio, {frames} frames) in {STREAM_CHUNK_S} s chunks, "
        f"OnlineRecognizer -> fbank pipeline -> StreamingSplicer -> CNN "
        f"(F = 64) -> StreamingDecoder (K {stream.dec.K}, beam 60): "
        f"{wall:.3f} s, RTF {wall / audio_s:.4f} (without the graph "
        f"captures {(wall - sum(stream.capture_seconds.values())) / audio_s:.4f}"
        f"); accept_waveform "
        f"{len(call_ms)} calls, median {np.median(call_ms):.2f} ms, p95 "
        f"{np.percentile(call_ms, 95):.2f} ms, max {max(call_ms):.2f} ms; "
        f"split: base features {secs['base features']:.3f} s, cmvn + deltas "
        f"(recomputed over the stream every chunk) {secs['cmvn + deltas']:.3f}"
        f" s, AM {secs['am']:.3f} s, search {secs['search']:.3f} s (host "
        f"pipeline share {100 * host / wall:.1f} %); graph capture s "
        f"{ {k: round(v, 3) for k, v in sorted(stream.capture_seconds.items())} }"
        f"; launches {launches}; traceback window max {window} levels "
        f"(commit_every {stream.commit_every}; not asserted: at this model's "
        f"WER the live tokens do not merge within an utterance, in the JAX "
        f"package too); vs decode_batch on the same rows "
        f"(words, tids, cost within {STREAM_COST_ABS}) differ on {bad_batch}; "
        f"streamed vs offline loglikes max |diff| {ll_err:.3g} (limit "
        f"{LOGLIKE_ATOL}); WER {res['wer']:.2f}% ({res['errors']} errors / "
        f"{res['words']} words; not asserted)")
    if launches["fbank_fft"] <= 0 or launches["conv_maxpool"] <= 0:
        raise AssertionError(f"a kernel did not run in the streaming phase: "
                             f"{launches}")
    if bad_batch or ll_err > LOGLIKE_ATOL:
        raise AssertionError("the streamed decode disagrees with the offline "
                             "one")

    log(f"streaming block graphs captured {sorted(stream.capture_seconds)} "
        f"(the ladder {StreamingDecoder.CHUNK_BLOCKS})")
    if sorted(stream.capture_seconds) != sorted(StreamingDecoder.CHUNK_BLOCKS):
        raise AssertionError("a block graph did not run in the recognizer")
    # device time of a block: its graph replayed back to back (the carry
    # is garbage by now; reset() precedes any further use)
    per_frame = {b.size: time_ms(b.graph.replay, iters=10) / b.size
                 for b in sorted(stream._runner.blocks.values(),
                                 key=lambda b: -b.size)}
    torch.cuda.synchronize()
    stream.reset()
    log(f"streaming block graphs: device ms a frame by CUDA events over 10 "
        f"replays: " + ", ".join(f"{k}-frame block {v:.4f}"
                                 for k, v in per_frame.items())
        + f"; search wall ms a frame in the recognizer run "
        f"{1e3 * secs['search'] / frames:.4f}")

    # ---- CPU replay of the shortest utterance ----------------------------
    u = min(utts, key=lambda k: len(test.waves[k]))
    am_cpu = AmNnet(copy.deepcopy(am.nnet).to("cpu"), num_pdfs)
    am_cpu.priors = am.priors.copy()
    cpu_stream = StreamingDecoder(TopKDecoder(
        hclg, beam=60.0, max_active=2000, acoustic_scale=wsj.ACOUSTIC_SCALE,
        device="cpu"))
    t = time.perf_counter()
    tids_c, words_c, cost_c, rows_c, _, _ = stream_utterance(
        test.waves[u], rate, am_cpu, cpu_stream, dict.fromkeys(secs, 0.0))
    cpu_s = time.perf_counter() - t
    tids, words, cost, rows = out[u]
    # the CPU's eager frames on the card's own rows, in the same chunks
    same_rows = stream_rows(cpu_stream, rows)
    diff_tids = int(np.sum(np.asarray(tids_c) != np.asarray(tids))) \
        if len(tids_c) == len(tids) else -1
    log(f"streaming replay on cpu ({u}, {len(rows)} frames, {cpu_s:.1f} s): "
        f"words equal: {list(words_c) == list(words)}, tids differing "
        f"{diff_tids}, cost {cost_c:.4f} vs {cost:.4f} (loglikes max |diff| "
        f"{float(np.abs(rows_c - rows).max()):.3g}); eager StreamingDecoder "
        f"on the card's rows: tids and words equal: "
        f"{list(same_rows[0]) == list(tids) and list(same_rows[1]) == list(words)}"
        f", cost {same_rows[2]:.4f} vs {cost:.4f} (limit {STREAM_COST_ABS})")
    if (list(words_c) != list(words) or list(same_rows[0]) != list(tids)
            or list(same_rows[1]) != list(words)
            or abs(same_rows[2] - cost) > STREAM_COST_ABS):
        raise AssertionError("the card's streaming decode disagrees with the "
                             "CPU replay")

    # ---- the online2-wav-latgen verb --------------------------------------
    d = os.path.join(tmp, "verb")
    os.makedirs(os.path.join(d, "lang"))
    write_gmm_model(os.path.join(d, "tri.mdl"), tri.trans_model, am_gmm)
    with open(os.path.join(d, "HCLG.txt"), "w") as f:
        hclg_fst.write_text(f)
    tri.word_table.write(os.path.join(d, "lang", "words.txt"))
    with open(os.path.join(d, "wav.scp"), "w") as f:
        for u in utts:
            path = os.path.join(d, f"{u}.wav")
            write_wave(path, test.waves[u], rate)
            f.write(f"{u} {path}\n")
    verb, by_run = {}, {"streaming": launches}
    for tag, extra in (("card", []), ("host", ["--host-decode"])):
        reset_launches()
        lat_path = os.path.join(d, f"lats_{tag}.npz")
        hyp_path = os.path.join(d, f"hyp_{tag}.txt")
        t = time.perf_counter()
        rc = cli.main(["online2-wav-latgen", "--feature-type=mfcc",
                       "--no-online-cmvn", "--beam=200", "--max-active=0",
                       f"--device={dev}",
                       f"--lattice-wspecifier={lat_path}",
                       f"--lang-dir={os.path.join(d, 'lang')}", *extra,
                       os.path.join(d, "tri.mdl"),
                       os.path.join(d, "HCLG.txt"),
                       os.path.join(d, "wav.scp"), hyp_path])
        torch.cuda.synchronize()
        secs_v = time.perf_counter() - t
        n = read_launches()
        with open(hyp_path) as f:
            lines = dict((ln.split(None, 1) + [""])[:2]
                         for ln in f.read().splitlines())
        lats = load_lattices(lat_path)
        bad = [u for u in utts if " ".join(
            tri.word_table.sym(int(w)) for w in shortest_path(
                lats[u], 1.0, wsj.ACOUSTIC_SCALE)[1]) != lines[u].strip()]
        wer = wer_details(test.transcripts,
                          {u: lines[u].split() for u in lines})
        verb[tag] = lines
        log(f"verb online2-wav-latgen ({tag}: {'host incremental Viterbi' if extra else 'StreamingDecoder'}"
            f", MFCC + deltas on the triphone GMM, {len(lats)} lattices): rc "
            f"{rc}, {secs_v:.3f} s, MFCC (fbank kernel) launches "
            f"{n['fbank_fft']}; lattice one-best differs from the hyp on "
            f"{bad}; WER {wer['wer']:.2f}% ({wer['errors']} errors / "
            f"{wer['words']} words; not asserted)")
        if rc != 0 or n["fbank_fft"] <= 0 or bad or sorted(lats) != utts:
            raise AssertionError(f"online2-wav-latgen ({tag}) failed")
        by_run[f"verb_{tag}"] = n
    log(f"verb: card and host hyps equal: {verb['card'] == verb['host']}")
    if verb["card"] != verb["host"]:
        raise AssertionError("the verb's card and host decodes disagree")
    bounded_stream(tri, am_gmm, hclg, test, dev)
    return by_run


def bounded_stream(tri, am_gmm, hclg, test, dev):
    """The streaming decoder's bounded host memory (the JAX package's
    tests/test_online2.py long-stream bar, on the card): the triphone
    GMM's loglikes of the test utterances' MFCC + deltas (the verb's
    features, through the fbank kernel), end to end as one stream in
    20-frame chunks, polled with best_path after every chunk, at beam
    30, acoustic scale 1 and commit_every 16.  The traceback window must
    stay within 8 x commit_every, the committed prefix must be >= 90 % of
    the path, and the result must equal decode_batch of the same rows
    (words, tids, cost within rel 1e-5)."""
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(test.sample_rate)
    opts.frame_opts.dither = 0.0
    rows = []
    for u in sorted(test.waves):
        cmvn = OnlineCmvn()
        cmvn.freeze(np.zeros(opts.num_ceps, np.float32))
        pipe = OnlineFeaturePipeline("mfcc", opts, cmvn=cmvn, device=dev)
        pipe.accept_waveform(test.waves[u])
        pipe.finish()
        rows.append(am_gmm.loglikes(pipe.get_frames(
            0, pipe.num_frames_ready())))
    rows = np.concatenate(rows).astype(np.float32)
    dec = TopKDecoder(hclg, beam=30.0, max_active=2000, acoustic_scale=1.0,
                      device=dev)
    stream = StreamingDecoder(dec, commit_every=16)
    window = 0
    t = time.perf_counter()
    for i in range(0, len(rows), 20):
        stream.advance(rows[i:i + 20])
        stream.best_path(use_final=False)
        window = max(window, len(stream._buf))
    stream.finalize()
    tids, words, cost = stream.best_path()
    stream_s = time.perf_counter() - t
    t = time.perf_counter()
    ((tids_o, words_o, cost_o),) = dec.decode_batch([rows])
    batch_s = time.perf_counter() - t
    same = (list(tids) == list(tids_o) and list(words) == list(words_o)
            and abs(cost - cost_o) <= 1e-5 * abs(cost_o))
    log(f"streaming bounded: {len(rows)} frames of triphone-GMM loglikes in "
        f"20-frame chunks (beam 30, acoustic scale 1, K {dec.K}), "
        f"{stream_s:.3f} s with a best_path poll a chunk (decode_batch "
        f"{batch_s:.3f} s): window max {window} levels (limit "
        f"{8 * stream.commit_every}), committed {len(stream._ctids)} of "
        f"{len(tids)} tids (limit 90 %); equal to decode_batch: {same} (cost "
        f"{cost:.4f} vs {cost_o:.4f})")
    if (window > 8 * stream.commit_every or not same
            or len(stream._ctids) < 0.9 * len(tids)):
        raise AssertionError("the streaming decoder's window grew or its "
                             "result differs from decode_batch")


def swbd_phase(dev, tmp):
    """Phase 10: swbd.run on the card at the recipe's size and width, then
    its dev and test rows (spliced volumes and aux rows, as the decode got
    them) through the plain versions on the CPU with the card's trained
    parameters.  Returns the kernels' launches in the run."""
    exp = os.path.join(tmp, "swbd")
    calls = {k: [] for k in ("compute_features", "compute_fbank_volumes",
                             "fit", "nnet_decode")}
    reset_launches()
    with contextlib.ExitStack() as stack:
        for name, c in calls.items():
            stack.enter_context(launches_per_call(swbd, name, c))
        probe = stack.enter_context(lattice_probes(swbd))
        t = time.perf_counter()
        res = swbd.run(nnet_epochs=SWBD_EPOCHS, device=dev, exp_dir=exp)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    launches = read_launches()
    per = {k: [n for _, n, _ in c] for k, c in calls.items()}

    def col(stage, kernel):
        return [n[kernel] for n in per[stage]]

    sec = probe["s"]
    K = min(2000, res["graph_states"])
    log(f"swbd: swbd.run(24 speakers x 7 utterances, {SWBD_EPOCHS} epochs, "
        f"F = 48, iVector 12 from a 16-Gaussian UBM, pnorm 800/160) "
        f"{total_s:.3f} s; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
        + f"; launches: mfcc stage fbank_fft "
        f"{per['compute_features'][0]['fbank_fft']}, iVector MFCC fbank_fft "
        f"{col('compute_features', 'fbank_fft')[1:]}, fbank volumes "
        f"fbank_fft {col('compute_fbank_volumes', 'fbank_fft')}, nnet_train "
        f"maxpool_fwd_vec {per['fit'][0]['maxpool_fwd_vec']} maxpool_bwd "
        f"{per['fit'][0]['maxpool_bwd']} maxpool_fwd_scalar "
        f"{per['fit'][0]['maxpool_fwd_scalar']}, decode conv_maxpool "
        f"{col('nnet_decode', 'conv_maxpool')} conv_maxpool_f32 "
        f"{col('nnet_decode', 'conv_maxpool_f32')}; run {launches}; triphone tree {res['tree_leaves']} leaves, HCLG "
        f"{res['graph_states']} states, K {K}; decode_batch_lattice calls "
        f"{len(probe['overflow'])}, (overflow, A_lat) "
        f"{sorted(set(probe['overflow']))}; lattice stages: frame loop "
        f"{sec['frame loop']:.3f} s, fetch {sec['fetch']:.3f}, assembly + "
        f"prune {sec['assembly + prune']:.3f}, determinize "
        f"{sec['determinize']:.3f}, score_sweep {sec['score_sweep']:.3f}; dev "
        f"WER {res['dev_wer']:.2f}% at {res['point']}, test WER "
        f"{res['wer']:.2f}% ({res['errors']} errors / {res['words']} words; "
        f"not asserted)")
    log(f"swbd nnet_train: {res['seconds']['nnet_train']:.3f} s "
        f"({SWBD_EPOCHS} epochs through Nnet.train_steps' CUDA graphs)")
    if (len(per["compute_features"]) != 3 or len(per["fit"]) != 1
            or len(per["nnet_decode"]) != 2):
        raise AssertionError(f"the recipe's stages ran other than expected: "
                             f"{ {k: len(v) for k, v in per.items()} }")
    if (min(col("compute_features", "fbank_fft")
            + col("compute_fbank_volumes", "fbank_fft")
            + col("fit", "maxpool_fwd_vec") + col("fit", "maxpool_bwd")
            + col("nnet_decode", "conv_maxpool")) <= 0):
        raise AssertionError(f"a kernel did not run in its stage: {per}")
    if not probe["overflow"] or any(ov != (0, 0)
                                    for ov, _ in probe["overflow"]):
        raise AssertionError(f"lattice overflow: {probe['overflow']}")
    if not (res["words"] > 0 and res["missing_utts"] == 0):
        raise AssertionError(f"the recipe's result is malformed: {res}")

    # ---- CPU replay of the decode on the card's rows and parameters -----
    (dev_args, _, dev_lats), (test_args, _, test_lats) = calls["nnet_decode"]
    am, hclg = dev_args[0], dev_args[2]
    am_cpu = AmNnet(copy.deepcopy(am.nnet).to("cpu"), am.num_pdfs)
    am_cpu.priors = am.priors.copy()
    _, dev_c, test_c = swbd.make_corpus()
    word_table = load_stage(exp, "gmm_bootstrap")[2].word_table
    t = time.perf_counter()
    ll_err, bad = 0.0, []
    cpu_lats = {}
    for (args, _, lats) in calls["nnet_decode"]:
        rows = args[1]
        lls_c = am_cpu.loglikes_batch(rows)
        ll_err = max(ll_err, max(float(np.abs(
            lls_c[u] - probe["loglikes"][u]).max()) for u in rows))
        cpu_lats.update(swbd.nnet_decode(am_cpu, rows, hclg))
        card, cpu = one_best(lats), one_best(cpu_lats)
        bad += [u for u in rows if card[u][0] != cpu[u][0]]
    dev_wer_c, pt_c, _ = swbd.score_sweep(
        {u: cpu_lats[u] for u in dev_lats}, dev_c.transcripts, word_table)
    cpu_s = time.perf_counter() - t
    log(f"swbd replay on cpu ({cpu_s:.1f} s; {len(dev_lats)} dev + "
        f"{len(test_lats)} test utterances, the card's rows and trained "
        f"parameters): loglikes max |diff| {ll_err:.3g} (limit "
        f"{LOGLIKE_ATOL}); one-best words differ on {bad}; swept point "
        f"{pt_c} vs {res['point']}, dev WER {dev_wer_c:.2f}% vs "
        f"{res['dev_wer']:.2f}%")
    if (ll_err > LOGLIKE_ATOL or bad or tuple(pt_c) != tuple(res["point"])
            or sorted(test_lats) != sorted(test_c.waves)):
        raise AssertionError("the card's Switchboard decode disagrees with "
                             "the CPU replay")
    return launches


def rm_phase(dev, tmp):
    """Phase 11: rm.run on the card at RM_UTTS utterances, then the test
    set's DNN rows (the fMLLR features of the GMM's first pass, spliced
    +-4) through the plain versions on the CPU with the card's trained
    parameters, and the card's loglikes through ``decode_utterances`` on
    the CPU.  Returns the kernels' launches in the run."""
    calls = {"compute_features": [], "nnet_decode": []}
    reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(launches_per_call(
            yesno, "compute_features", calls["compute_features"]))
        stack.enter_context(launches_per_call(rm, "nnet_decode",
                                              calls["nnet_decode"]))
        probe = stack.enter_context(lattice_probes(rm))
        t = time.perf_counter()
        res = rm.run(num_utts=RM_UTTS, nnet_epochs=RM_EPOCHS, device=dev,
                     exp_dir=os.path.join(tmp, "rm"))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    launches = read_launches()
    mfcc = [n["fbank_fft"] for _, n, _ in calls["compute_features"]]
    sec = probe["s"]
    log(f"rm: rm.run({RM_UTTS} utterances, seed 29, {RM_EPOCHS} epochs, "
        f"LDA 7 x 13 -> 20, tri2b 250 leaves / 800 Gaussians, SAT 900 "
        f"Gaussians, pnorm 800/160 on 180-dim fMLLR rows) {total_s:.3f} s; "
        f"stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
        + f"; MFCC fbank_fft launches {mfcc}; run {launches}; tree "
        f"{res['tree_leaves']} leaves, HCLG {res['graph_states']} states; "
        f"decode_batch_lattice calls {len(probe['overflow'])}, (overflow, "
        f"A_lat) {sorted(set(probe['overflow']))}; DNN lattice stages: "
        f"frame loop {sec['frame loop']:.3f} s, fetch {sec['fetch']:.3f}, "
        f"assembly + prune {sec['assembly + prune']:.3f}, determinize "
        f"{sec['determinize']:.3f}, score_sweep {sec['score_sweep']:.3f}; "
        f"GMM-SAT dev WER {res['gmm_dev_wer']:.2f}% at {res['gmm_point']} "
        f"test {res['gmm_test_wer']:.2f}%; DNN dev WER "
        f"{res['dnn_dev_wer']:.2f}% at {res['dnn_point']} test "
        f"{res['wer']:.2f}% ({res['errors']} errors / {res['words']} "
        f"words; not asserted)")
    log(f"rm dnn_train: {res['seconds']['dnn_train']:.3f} s "
        f"({RM_EPOCHS} epochs through Nnet.train_steps' CUDA graphs)")
    if len(mfcc) != 3 or min(mfcc) <= 0 or launches["fbank_fft"] <= 0:
        raise AssertionError(f"the fbank kernel did not run in each MFCC "
                             f"call: {mfcc}, run {launches}")
    if not probe["overflow"] or any(ov != (0, 0)
                                    for ov, _ in probe["overflow"]):
        raise AssertionError(f"lattice overflow: {probe['overflow']}")
    if not (RM_KEYS <= set(res) and res["words"] > 10
            and res["missing_utts"] == 0
            and len(calls["nnet_decode"]) == 2):
        raise AssertionError(f"the recipe's result is malformed: "
                             f"{ {k: v for k, v in res.items() if k != 'per_utt'} }")

    # ---- CPU replay of the test decode on the card's rows and params ----
    (am, feats, hclg), _, lats = calls["nnet_decode"][1]
    am_cpu = AmNnet(copy.deepcopy(am.nnet).to("cpu"), am.num_pdfs)
    am_cpu.priors = am.priors.copy()
    t = time.perf_counter()
    rows = {u: F.splice_frames(g, rm.CONTEXT, rm.CONTEXT)
            for u, g in feats.items()}
    lls_c = am_cpu.loglikes_batch(rows)
    ll_err = max(float(np.abs(lls_c[u] - probe["loglikes"][u]).max())
                 for u in rows)
    cpu_lats = rm.decode_utterances(
        hclg, {u: probe["loglikes"][u] for u in rows},
        acoustic_scale=rm.ACOUSTIC_SCALE, beam=60.0, lattice_beam=8.0,
        max_active=2000, lattice_arcs_per_frame=None, device="cpu")
    card, cpu = one_best(lats), one_best(cpu_lats)
    bad = [u for u in rows if card[u][0] != cpu[u][0]]
    cost = max(abs(card[u][1] - cpu[u][1]) / max(1.0, abs(card[u][1]))
               for u in rows)
    log(f"rm replay on cpu ({time.perf_counter() - t:.1f} s; {len(rows)} "
        f"test utterances, {sum(len(r) for r in rows.values())} rows of "
        f"{next(iter(rows.values())).shape[1]} columns, the card's trained "
        f"parameters): loglikes max |diff| {ll_err:.3g} (limit "
        f"{LOGLIKE_ATOL}); decode_utterances on the card's loglikes: "
        f"one-best words differ on {bad}, largest relative cost diff "
        f"{cost:.3g}")
    if (ll_err > LOGLIKE_ATOL or bad or sorted(lats) != sorted(rows)
            or any(not np.isfinite(v).all() for v in lls_c.values())):
        raise AssertionError("the card's RM decode disagrees with the CPU "
                             "replay")
    return launches


def librispeech_phase(dev, tmp):
    """Phase 12: librispeech.run on the card at the recipe's defaults, as a
    process group of one over NCCL, then the test set's rows through the
    plain versions on the CPU with the card's trained parameters, and the
    card's loglikes through ``decode_utterances`` on the CPU.  Returns
    (the kernels' launches in the run, the result)."""
    calls = {k: [] for k in ("compute_features", "compute_fbank_volumes",
                             "train_multihost", "nnet_decode")}
    reset_launches()
    with contextlib.ExitStack() as stack:
        for name, c in calls.items():
            stack.enter_context(launches_per_call(librispeech, name, c))
        probe = stack.enter_context(lattice_probes(librispeech))
        eager_calls = stack.enter_context(counted_eager_steps())
        step_objfs = stack.enter_context(recorded_train_steps())
        t = time.perf_counter()
        res = librispeech.run(num_utts=LIBRI_UTTS, nnet_epochs=LIBRI_EPOCHS,
                              device=dev,
                              exp_dir=os.path.join(tmp, "librispeech"))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    launches = read_launches()
    reduces = mesh_ops.all_reduce.launches
    warm_reduces = mesh_ops.all_reduce.warmup_launches
    per = {k: [n for _, n, _ in c] for k, c in calls.items()}
    train_net = calls["train_multihost"][0][0][0]
    train_s = res["seconds"]["nnet_train"]

    def col(stage, kernel):
        return [n[kernel] for n in per[stage]]

    sec = probe["s"]
    log(f"librispeech: librispeech.run({LIBRI_UTTS} utterances, seed 53, "
        f"{LIBRI_EPOCHS} epochs, F = 48, pnorm 800/160, minibatch 256, "
        f"8 egs shards; {res['num_devices']} rank over {res['backend']}) "
        f"{total_s:.3f} s; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
        + f"; training {res['train_audio_ss']:.1f} audio-s/s, "
        f"{len(step_objfs)} steps in {train_s:.3f} s "
        f"({1e3 * train_s / max(len(step_objfs), 1):.3f} ms a step, "
        f"captures included) through the dp step's CUDA graphs "
        f"({captures(train_net)}; eager-loop calls {len(eager_calls)}); "
        f"all-reduces {reduces} ({warm_reduces} in graph warm-ups, the "
        f"rest eager or replayed from captures); launches: bootstrap MFCC "
        f"fbank_fft "
        f"{col('compute_features', 'fbank_fft')}, fbank volumes fbank_fft "
        f"{col('compute_fbank_volumes', 'fbank_fft')}, nnet_train "
        f"maxpool_fwd_vec {col('train_multihost', 'maxpool_fwd_vec')} "
        f"maxpool_bwd {col('train_multihost', 'maxpool_bwd')} "
        f"maxpool_fwd_scalar {col('train_multihost', 'maxpool_fwd_scalar')}"
        f", decode conv_maxpool {col('nnet_decode', 'conv_maxpool')} "
        f"conv_maxpool_f32 {col('nnet_decode', 'conv_maxpool_f32')}; run "
        f"{launches}; tree {res['tree_leaves']} leaves, HCLG "
        f"{res['graph_states']} states; decode_batch_lattice calls "
        f"{len(probe['overflow'])}, (overflow, A_lat) "
        f"{sorted(set(probe['overflow']))}; lattice stages: frame loop "
        f"{sec['frame loop']:.3f} s, fetch {sec['fetch']:.3f}, assembly + "
        f"prune {sec['assembly + prune']:.3f}, determinize "
        f"{sec['determinize']:.3f}, score_sweep {sec['score_sweep']:.3f}; dev "
        f"WER {res['dev_wer']:.2f}% at {res['point']}, test WER "
        f"{res['wer']:.2f}% ({res['errors']} errors / {res['words']} words; "
        f"not asserted)")
    if (len(per["compute_features"]) != 1 or len(per["train_multihost"]) != 1
            or len(per["compute_fbank_volumes"]) != 3
            or len(per["nnet_decode"]) != 2):
        raise AssertionError(f"the recipe's stages ran other than expected: "
                             f"{ {k: len(v) for k, v in per.items()} }")
    if (min(col("compute_features", "fbank_fft")
            + col("compute_fbank_volumes", "fbank_fft")
            + col("train_multihost", "maxpool_fwd_vec")
            + col("train_multihost", "maxpool_bwd")
            + col("nnet_decode", "conv_maxpool")) <= 0):
        raise AssertionError(f"a kernel did not run in its stage: {per}")
    if res["backend"] != "nccl" or res["num_devices"] != 1 or reduces <= 0:
        raise AssertionError(f"the run did not go through an NCCL group: "
                             f"{res['backend']}, {res['num_devices']} "
                             f"ranks, {reduces} all-reduces")
    if eager_calls or not train_net.capture_seconds:
        raise AssertionError("train_multihost did not run through the dp "
                             "step's CUDA graphs")
    if not probe["overflow"] or any(ov != (0, 0)
                                    for ov, _ in probe["overflow"]):
        raise AssertionError(f"lattice overflow: {probe['overflow']}")
    if not (LIBRI_KEYS <= set(res) and res["words"] > 10
            and res["missing_utts"] == 0):
        raise AssertionError(f"the recipe's result is malformed: "
                             f"{ {k: v for k, v in res.items() if k != 'per_utt'} }")

    # ---- CPU replay of the test decode on the card's rows and params ----
    (am, vols, hclg, _), _, lats = calls["nnet_decode"][1]
    am_cpu = AmNnet(copy.deepcopy(am.nnet).to("cpu"), am.num_pdfs)
    am_cpu.priors = am.priors.copy()
    t = time.perf_counter()
    rows = {u: wsj.splice_volume(v, librispeech.LEFT, librispeech.RIGHT)
            for u, v in vols.items()}
    lls_c = am_cpu.loglikes_batch(rows)
    ll_err = max(float(np.abs(lls_c[u] - probe["loglikes"][u]).max())
                 for u in rows)
    # one batch padded to the longest utterance: each utterance's search
    # is its own row's, and the CPU's frame loop runs the fewest frames
    longest = max(v.shape[0] for v in vols.values())
    cpu_lats = librispeech.decode_utterances(
        hclg, {u: probe["loglikes"][u] for u in rows}, acoustic_scale=0.1,
        beam=60.0, lattice_beam=8.0, max_active=2000,
        lattice_arcs_per_frame=None, batch_size=len(rows),
        bucket_frames=-(-longest // 32) * 32, device="cpu")
    card, cpu = one_best(lats), one_best(cpu_lats)
    bad = [u for u in rows if card[u][0] != cpu[u][0]]
    cost = max(abs(card[u][1] - cpu[u][1]) / max(1.0, abs(card[u][1]))
               for u in rows)
    log(f"librispeech replay on cpu ({time.perf_counter() - t:.1f} s; "
        f"{len(rows)} test utterances, {sum(len(r) for r in rows.values())} "
        f"rows, the card's trained parameters): loglikes max |diff| "
        f"{ll_err:.3g} (limit {LOGLIKE_ATOL}); decode_utterances on the "
        f"card's loglikes: one-best words differ on {bad}, largest relative "
        f"cost diff {cost:.3g}")
    if (ll_err > LOGLIKE_ATOL or bad or sorted(lats) != sorted(rows)
            or any(not np.isfinite(v).all() for v in lls_c.values())):
        raise AssertionError("the card's Librispeech decode disagrees with "
                             "the CPU replay")
    return launches, res


def libri_cfg(num_pdfs: int) -> ConvnetConfig:
    """The Librispeech recipe's net (recipes/librispeech.py)."""
    return ConvnetConfig(in_t=11, in_f=36, in_c=3, filt_t=4, filt_f=7,
                         num_filters=48, pool_t=2, pool_f=3, pool_c=1,
                         num_hidden_layers=2, pnorm_input_dim=800,
                         pnorm_output_dim=160, num_pdfs=num_pdfs)


def nccl_graph_phase(num_pdfs):
    """Phase 12b: ``train_multihost`` over an NCCL group of one at the
    recipe's width and the phase-12 tree's pdfs, NCCL_STEPS steps of
    DP_ROWS rows, through the dp step's graphs and through the eager
    loop under deterministic cuDNN: objfs, parameters and NG states
    bit-equal; the replays' all-reduces and maxpool launches equal the
    eager run's; no eager-loop call in the graphed run.  Prints ms a
    step of both in the NG warm-up and after it."""
    t = time.perf_counter()
    r = rank_check.nccl_graphs_vs_eager(libri_cfg(num_pdfs), NCCL_STEPS,
                                        DP_ROWS, 0.08, SEED)
    g, e = r["graphed"], r["eager"]
    caps = g["captures"]
    log(f"librispeech dp step graphed vs eager (train_multihost, mode A "
        f"over NCCL at world size 1, deterministic cuDNN, {r['steps']} "
        f"steps of {r['rows']} rows at the recipe's width, {num_pdfs} pdfs; "
        f"{r['refreshes'][0]} refreshing steps, {r['refreshes'][1]} after "
        f"the NG warm-up; {gpu_line()}; {time.perf_counter() - t:.1f} s): "
        f"bit-equal {r['same']}; ms a step graphed {g['ms_warmup']:.3f} in "
        f"the warm-up, {g['ms_steady']:.3f} after it, eager "
        f"{e['ms_warmup']:.3f} / {e['ms_steady']:.3f} (captures "
        f"excluded); train_multihost {g['seconds']:.3f} s graphed, "
        f"{e['seconds']:.3f} s eager; {len(caps)} graphs captured in "
        f"{sum(caps.values()):.3f} s; all-reduces {g['all_reduces']} "
        f"replayed or eager + {g['warmup']['all_reduces']} in warm-ups, "
        f"eager {e['all_reduces']}; maxpool fwd/bwd {g['maxpool']} + "
        f"{g['warmup']['maxpool']} in warm-ups, eager {e['maxpool']}; "
        f"eager-loop calls graphed {g['eager_calls']}, eager "
        f"{e['eager_calls']}; objf {r['objf'][0]:.4f} -> {r['objf'][1]:.4f}")
    if (not all(r["same"].values()) or g["all_reduces"] != e["all_reduces"]
            or g["maxpool"] != e["maxpool"] or g["eager_calls"]
            or e["eager_calls"] != r["steps"] or not caps
            or r["refreshes"][1] < 3 or min(e["maxpool"]) <= 0):
        raise AssertionError("train_multihost through the graphs is not the "
                             "eager training bit for bit")
    return r


def two_rank_phase(num_pdfs):
    """Two gloo ranks with CUDA tensors on the one card, at the Librispeech
    recipe's net width and the phase-12 tree's pdfs
    (``parallel/rank_check.py``): DP_STEPS mode-A steps (each rank half of
    a DP_ROWS minibatch) against the single-process steps on the whole of
    it, and two replicas (DP_STEPS steps on each half, one average)
    against the mean of the two single-process streams; then the two
    ranks as the model shards of one data slot (``make_dp_tp_step``, the
    wide Affine layers split by rows) against the single-process steps.
    Objf within OBJF_STEP_ATOL, parameters within PARAM_REL (relative
    Frobenius); the two ranks bit-equal."""
    cfg = libri_cfg(num_pdfs)
    case = rank_check.seeded_case(cfg, SEED, DP_ROWS)
    for replicas in (1, 2):
        res = rank_check.two_ranks_vs_one(cfg, case, DP_STEPS, 0.08,
                                          replicas)
        l0, l1 = res["launches"]
        log(f"two ranks on the card ({'mode A' if replicas == 1 else 'two replicas, one average'}"
            f", gloo, {DP_STEPS} steps of {DP_ROWS} rows at the recipe's "
            f"width, {num_pdfs} pdfs; {res['seconds']:.1f} s with the "
            f"spawn): ranks bit-equal {res['ranks_equal']}; against world "
            f"size 1: objf max |diff| {res['objf_err']:.3g} (limit "
            f"{OBJF_STEP_ATOL}), params max relative Frobenius diff "
            f"{res['param_rel']:.3g} (limit {PARAM_REL}); maxpool fwd/bwd "
            f"launches {l0} {l1}")
        if (not res["ranks_equal"] or res["objf_err"] > OBJF_STEP_ATOL
                or res["param_rel"] > PARAM_REL or min(l0 + l1) <= 0):
            raise AssertionError("the two ranks on the card disagree with "
                                 "world size 1")
    res = rank_check.tp_two_ranks_vs_one(cfg, case, DP_STEPS, 0.08)
    log(f"two ranks on the card (tensor parallel: make_dp_tp_step, data 1 "
        f"x model 2, {res['sharded']} Affine layers split by rows; gloo, "
        f"{DP_STEPS} steps of {DP_ROWS} rows; {res['seconds']:.1f} s with "
        f"the spawn): ranks bit-equal {res['ranks_equal']}; against world "
        f"size 1: objf max |diff| {res['objf_err']:.3g} (limit "
        f"{OBJF_STEP_ATOL}), params max relative Frobenius diff "
        f"{res['param_rel']:.3g} (limit {PARAM_REL}); elementwise against "
        f"the JAX bar rtol {rank_check.TP_RTOL} / atol {rank_check.TP_ATOL}"
        f": worst excess {res['param_excess']:.3g} (<= 0 within; not "
        f"asserted)")
    if (not res["ranks_equal"] or res["sharded"] < 2
            or res["objf_err"] > OBJF_STEP_ATOL
            or res["param_rel"] > PARAM_REL):
        raise AssertionError("the tensor-parallel ranks on the card disagree "
                             "with world size 1")


def nnet2_chain(mfcc, ali, t2p, num_pdfs, dev):
    """The nnet2 chain at the WSJ MFCC width on ``dev``: Splice +-4 ->
    FixedAffine (estimate_feature_transform on the spliced frames of
    ``mfcc`` labeled by the pdfs of ``ali``) -> Affine -> RectifiedLinear
    -> Affine -> Tanh -> Affine -> Sigmoid -> Dropout -> Affine ->
    Softmax, CHAIN_HIDDEN wide, seeded weights."""
    keys = [u for u in sorted(mfcc) if u in ali
            and len(ali[u]) == len(mfcc[u])]
    x = np.concatenate([F.splice_frames(mfcc[u], 4, 4) for u in keys])
    y = np.concatenate([t2p[ali[u]] for u in keys])
    d_in, h = mfcc[keys[0]].shape[1], CHAIN_HIDDEN
    ft = estimate_feature_transform(x, y, device=dev)
    net = Nnet([C.SpliceComponent(d_in, 4, 4), ft,
                C.AffineComponent(9 * d_in, h, device=dev),
                C.RectifiedLinearComponent(h),
                C.AffineComponent(h, h, device=dev), C.TanhComponent(h),
                C.AffineComponent(h, h, device=dev), C.SigmoidComponent(h),
                C.DropoutComponent(h, 0.2),
                C.AffineComponent(h, num_pdfs, param_stddev=1.0 / h ** 0.5,
                                  device=dev),
                C.SoftmaxComponent(num_pdfs)])
    return net.init(torch_generator(SEED, "nnet2_chain")), keys


def mmi_phase(dev, exp_dir, tmp, word_probs):
    """Phase 13: sequence-discriminative training of phase 8's CNN on the
    card (``mmi_train_nnet``: Nnet.predict with the fused conv+maxpool
    kernel, the host lattice_decode, discriminative_step's CUDA graphs
    with the maxpool kernels), the same on a copy of the net with the
    eager step, one of its steps replayed on the CPU, and an nnet2 chain
    written to a .mdl, read on the card and on the CPU and trained one
    step on the card.  Returns the kernels' launches in mmi_train_nnet."""
    t_phase = time.perf_counter()
    _, ali, tri = load_stage(exp_dir, "gmm_bootstrap")
    vol_tr = load_stage(exp_dir, "fbank")[0]
    egs_train, _ = wsj.split_valid(load_stage(exp_dir, "egs"))
    t2p = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    hclg = CompiledGraph(make_hclg_from_arpa(tri, make_unigram_arpa(
        word_probs)), t2p)
    net = make_convnet(wsj.model_config(36, num_pdfs), fused=True,
                       device=dev)
    params_from_jax(net, load_stage(exp_dir, "nnet_train"))
    am = wsj.acoustic_model(net, egs_train, num_pdfs)
    keys = [u for u in sorted(vol_tr) if u in ali
            and len(ali[u]) == len(vol_tr[u])][:MMI_UTTS]
    utts = [(wsj.splice_volume(vol_tr[u], wsj.CONTEXT, wsj.CONTEXT),
             t2p[ali[u]]) for u in keys]
    frames = sum(len(a) for _, a in utts)

    # each step: its denominator's row sums and its seconds; the first
    # step's parameters and NG states before and after, for the replay
    def recording(net, steps, first):
        step = net.discriminative_step

        def recorded(opt, x, num, den, lr, **kw):
            if not first:
                first.update(params=copy.deepcopy(params_to_numpy(net)),
                             opt=opt_to_numpy(opt), x=torch.as_tensor(x),
                             num=torch.as_tensor(num),
                             den=torch.as_tensor(den), lr=lr,
                             period=net.ng_in.update_period)
            sums = np.asarray(den).sum(axis=1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(opt, x, num, den, lr, **kw)
            torch.cuda.synchronize()
            steps.append((len(x), time.perf_counter() - t, sums))
            if "objf" not in first:
                first.update(objf=float(out[1]),
                             after=copy.deepcopy(params_to_numpy(net)))
            return out
        return recorded

    # the eager twin: the same net stepped op by op
    eager_net = copy.deepcopy(net)
    eager_net.discriminative_step = eager_net.discriminative_step_eager
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, n in (("graphed", net), ("eager", eager_net)):
            steps, first = [], {}
            n.discriminative_step = recording(n, steps, first)
            reset_launches()
            t = time.perf_counter()
            opt, history = mmi_train_nnet(n, n.init_opt(), utts, hclg, t2p,
                                          am.priors, num_iters=MMI_ITERS,
                                          learning_rate=MMI_LR, device=dev)
            torch.cuda.synchronize()
            runs[name] = dict(s=time.perf_counter() - t, steps=steps,
                              first=first, opt=opt, history=history,
                              launches=read_launches())
            del n.discriminative_step
    finally:
        torch.backends.cudnn.deterministic = False
    g, e = runs["graphed"], runs["eager"]
    steps, first, history, mmi_s = g["steps"], g["first"], g["history"], g["s"]
    launches = g["launches"]
    den_err = max(float(np.abs(s - 1.0).max()) for _, _, s in steps)
    step_ms = [1e3 * sec / n for n, sec, _ in steps]
    caps = net.capture_seconds
    disc_caps = sorted(k for k in caps if k[0] == "disc")
    tail_caps = [k for k in caps if k[0] == "tail"]
    ms = {k: [1e3 * sec for _, sec, _ in runs[k]["steps"]] for k in runs}
    log(f"mmi: mmi_train_nnet on phase 8's CNN (F = 64, {num_pdfs} pdfs), "
        f"{len(utts)} training utterances ({frames} frames), {MMI_ITERS} "
        f"iterations, lr {MMI_LR}: {mmi_s:.3f} s graphed, {e['s']:.3f} s "
        f"eager; objf history {[round(h, 5) for h in history]} (not "
        f"asserted); discriminative_step median "
        f"{np.median(ms['graphed']):.3f} ms graphed (first use of a graph "
        f"included), "
        f"{np.median(ms['eager']):.3f} ms eager ({np.median(step_ms):.4f} "
        f"ms a frame graphed, {len(steps)} steps of "
        f"{min(n for n, _, _ in steps)}-{max(n for n, _, _ in steps)} "
        f"frames); denominator row sums max |1 - sum| {den_err:.3g} (limit "
        f"{MMI_DEN_ATOL}); launches {launches}")
    replayed = ms["graphed"][len(utts):]
    log(f"mmi graphs: {len(disc_caps)} step graphs {disc_caps} and "
        f"{len(tail_caps)} tail graphs, {sum(caps.values()):.3f} s of "
        f"captures, {len(steps)} step replays; the second iteration's "
        f"steps {np.median(replayed):.3f} ms median graphed against "
        f"{np.median(ms['eager'][len(utts):]):.3f} ms eager")
    same = (history == e["history"] and all(
        np.array_equal(a[k], b[k]) for a, b in zip(
            params_to_numpy(net), params_to_numpy(eager_net)) for k in a)
        and all(torch.equal(x.u, y.u) and torch.equal(x.d, y.d)
                and torch.equal(x.rho, y.rho) and x.t == y.t
                for (_, x), (_, y) in zip(ng_states(g["opt"]),
                                          ng_states(e["opt"]))))
    log(f"mmi graphed vs eager (deterministic cuDNN): objf history, "
        f"parameters and NG states bit-equal: {same}; eager launches "
        f"{e['launches']}")
    if not same:
        raise AssertionError("the graphed MMI steps differ from the eager "
                             "ones")
    need = ("conv_maxpool", "maxpool_fwd_vec", "maxpool_bwd")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"a kernel did not run in the MMI phase: "
                             f"{launches}")
    if (len(steps) != MMI_ITERS * len(utts) or den_err > MMI_DEN_ATOL
            or len(history) != MMI_ITERS or not np.isfinite(history).all()
            or not disc_caps):
        raise AssertionError(f"the MMI phase's result is malformed: "
                             f"{len(steps)} steps, history {history}, "
                             f"den error {den_err}, graphs {disc_caps}")
    if net.ng_in.update_period != 16:
        raise AssertionError("mmi_train_nnet kept its update period")

    # ---- the first step replayed on the CPU ------------------------------
    cpu = make_convnet(wsj.model_config(36, num_pdfs), device="cpu")
    params_from_jax(cpu, first["params"])
    cpu.ng_in.update_period = cpu.ng_out.update_period = first["period"]
    _, objf_c = cpu.discriminative_step(
        opt_from_jax(first["opt"], "cpu"), first["x"], first["num"],
        first["den"], first["lr"])
    objf_err = abs(float(objf_c) - first["objf"])
    rel = max(float(np.linalg.norm(a[k] - b[k]) / max(
        np.linalg.norm(b[k]), 1e-30)) for a, b in zip(
        first["after"], params_to_numpy(cpu)) for k in a)
    log(f"mmi replay on cpu (step 1, {len(first['x'])} frames, update "
        f"period {first['period']}): objf {first['objf']:.6f} vs "
        f"{float(objf_c):.6f}, |diff| {objf_err:.3g} (limit "
        f"{OBJF_STEP_ATOL}); params max relative Frobenius diff {rel:.3g} "
        f"(limit {PARAM_REL})")
    if objf_err > OBJF_STEP_ATOL or rel > PARAM_REL:
        raise AssertionError("the card's MMI step disagrees with the CPU "
                             "replay")

    # ---- an nnet2 chain through a .mdl -------------------------------------
    mfcc = load_stage(exp_dir, "mfcc")
    chain, ckeys = nnet2_chain(mfcc, ali, t2p, num_pdfs, dev)
    path = os.path.join(tmp, "nnet2_chain.mdl")
    write_am_nnet(path, tri.trans_model, chain, None, am.priors)
    _, net_card, _, priors = read_am_nnet(path, device=dev)
    _, net_cpu, _, _ = read_am_nnet(path, device="cpu")
    am_card, am_cpu = AmNnet(net_card, num_pdfs), AmNnet(net_cpu, num_pdfs)
    am_card.priors = am_cpu.priors = np.asarray(priors, np.float64)
    u = ckeys[0]
    ll, ll_c = am_card.loglikes(mfcc[u]), am_cpu.loglikes(mfcc[u])
    ll_err = float(np.abs(ll - ll_c).max())
    opt = net_card.init_opt()
    _, objf = net_card.train_step(
        opt, torch.as_tensor(mfcc[u], device=dev),
        torch.as_tensor(t2p[ali[u]], device=dev), 0.01,
        generator=torch_generator(SEED, "train_step", 0, dev))
    objf = float(objf)
    log(f"mmi nnet2 chain: "
        + " -> ".join(type(c).__name__.replace("Component", "")
                      for c in net_card.components)
        + f" ({mfcc[u].shape[1]}-dim MFCC, hidden {CHAIN_HIDDEN}) through "
        f"{os.path.basename(path)}: loglikes card vs cpu on {u} "
        f"({len(ll)} frames) max |diff| {ll_err:.3g} (limit {LOGLIKE_ATOL}); "
        f"one train step on the card with a generator: objf {objf:.4f}")
    if (ll.shape != (len(mfcc[u]), num_pdfs) or not np.isfinite(ll).all()
            or ll_err > LOGLIKE_ATOL or not np.isfinite(objf)):
        raise AssertionError("the nnet2 chain's .mdl disagrees between the "
                             "card and the CPU, or its step failed")
    phase_s = time.perf_counter() - t_phase
    log(f"mmi phase: {phase_s:.1f} s (limit {MMI_PHASE_S})")
    if phase_s > MMI_PHASE_S:
        raise AssertionError(f"the MMI phase took {phase_s:.1f} s")
    return launches


def run_verb(argv, secs):
    """``cli.main(argv)`` on the card (the verbs' default device); its
    seconds go to ``secs[argv[0]]``; returns its stdout."""
    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs[argv[0]] = secs.get(argv[0], 0.0) + time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"{argv[0]} exited {rc}: {argv}")
    return out.getvalue()


@contextlib.contextmanager
def recorded_scores(out):
    """Wraps ``cli_train._load_am`` so that each loglike matrix its
    scorer returns is appended to ``out``."""
    load = cli_train._load_am

    def wrapped(path, device="cuda"):
        tm, scorer, dim = load(path, device)

        def scored(f):
            ll = scorer(f)
            out.append(np.asarray(ll, np.float32))
            return ll
        return tm, scored, dim

    cli_train._load_am = wrapped
    try:
        yield out
    finally:
        cli_train._load_am = load


def cli_phase(dev, exp_dir, tmp, test):
    """Phase 14: the shell pipeline through the verbs on the card; returns
    the kernels' launches in the phase."""
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "cli")

    def p(*names):
        return os.path.join(d, *names)

    reset_launches()
    # ---- (a) the shell pipeline on a small yesno corpus -------------------
    secs = {}
    lex = synthetic.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = synthetic.make_corpus(lex, wp, CLI_UTTS, 1, 3, seed=23)
    train, ytest = corpus.split(0.2)
    for part, c in (("train", train), ("test", ytest)):
        write_data_dir(p(part), c.waves, c.transcripts, None,
                       corpus.sample_rate)
    write_lexicon_file(p("lexicon.txt"), lex)
    with open(p("unigram.arpa"), "w") as f:
        f.write(make_unigram_arpa(wp))
    steps = []
    for part in ("train", "test"):
        steps += [["compute-mfcc-feats", "--dither=0", p(part, "wav.scp"),
                   p(f"{part}_mfcc.ark")],
                  ["add-deltas", p(f"{part}_mfcc.ark"), p(f"{part}_feats.ark"),
                   f"--out-scp={p(f'{part}_feats.scp')}"]]
    steps += [
        ["prepare-lang", p("lexicon.txt"), p("lang")],
        ["gmm-train-mono", f"--num-iters={CLI_MONO_ITERS}", "--totgauss=300",
         p("lang"), p("train_feats.scp"), p("train", "text"), p("mono.mdl"),
         p("ali0.ark")],
        ["compile-train-graphs", p("lang"), p("train", "text"),
         p("graphs.txt")],
        ["gmm-align", "--beam=200", p("mono.mdl"), p("graphs.txt"),
         p("train_feats.scp"), p("ali.ark")],
        ["nnet-get-egs", "--left-context=4", "--right-context=4",
         p("mono.mdl"), p("train_feats.scp"), p("ali.ark"), p("egs.npz")],
        ["nnet-train", f"--num-epochs={CLI_EPOCHS}", "--minibatch-size=128",
         "--initial-learning-rate=0.04", "--final-learning-rate=0.004",
         "--num-hidden-layers=1", "--pnorm-input-dim=200",
         "--pnorm-output-dim=40", p("mono.mdl"), p("egs.npz"), p("am.mdl")],
        ["mkgraph", p("lang"), p("unigram.arpa"), p("HCLG.txt")],
        ["splice-feats", "--left-context=4", "--right-context=4",
         p("test_feats.ark"), p("test_spliced.ark"),
         f"--out-scp={p('test_spliced.scp')}"],
        # the host search here: the batched search's host cost on 8
        # padded utterances (17.3 s on the H100's host) would take most
        # of the phase's limit; (b) decodes on the card
        ["latgen-faster", "--host-decode", "--beam=1e9", "--max-active=0",
         "--acoustic-scale=0.1", f"--lang-dir={p('lang')}", p("am.mdl"),
         p("HCLG.txt"), p("test_spliced.scp"), p("lats.npz"), p("hyp.txt")]]
    for argv in steps:
        run_verb(argv, secs)
    wer_line = run_verb(["compute-wer", p("test", "text"), p("hyp.txt")],
                        secs).strip()
    hyps = cli_train._read_text(p("hyp.txt"))
    pipe_s = sum(secs.values())
    log(f"cli pipeline: {len(train.waves)} train / {len(ytest.waves)} test "
        f"yesno utterances, mono {CLI_MONO_ITERS} iterations, DNN "
        f"{CLI_EPOCHS} epochs: {pipe_s:.3f} s; "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f"; {wer_line} (not asserted); launches {read_launches()}")
    if sorted(hyps) != sorted(ytest.waves) or not wer_line.startswith(
            "%WER"):
        raise AssertionError(f"the verb pipeline's output is malformed: "
                             f"{wer_line!r}, {sorted(hyps)}")

    # ---- (b) phase 8's CNN through the verbs ------------------------------
    secs = {}
    tri, _, hclg_fst, hclg, am = phase8_model(dev, exp_dir, test)
    write_data_dir(p("wsj"), test.waves, test.transcripts, None,
                   test.sample_rate)
    os.makedirs(p("wsj_lang"))
    tri.word_table.write(p("wsj_lang", "words.txt"))
    with open(p("wsj_HCLG.txt"), "w") as f:
        hclg_fst.write_text(f)
    write_am_nnet(p("cnn.mdl"), tri.trans_model, am.nnet, None, am.priors)
    for argv in (
            ["compute-fbank-feats", "--num-mel-bins=36", "--dither=0",
             p("wsj", "wav.scp"), p("wsj_fbank.ark")],
            ["add-deltas", p("wsj_fbank.ark"), p("wsj_deltas.ark")],
            ["splice-feats", f"--left-context={wsj.CONTEXT}",
             f"--right-context={wsj.CONTEXT}", p("wsj_deltas.ark"),
             p("wsj_spliced.ark"), f"--out-scp={p('wsj_spliced.scp')}"]):
        run_verb(argv, secs)
    decode = ["--beam=60", "--max-active=2000", "--lattice-beam=8",
              f"--acoustic-scale={wsj.ACOUSTIC_SCALE}",
              f"--lang-dir={p('wsj_lang')}", p("cnn.mdl"), p("wsj_HCLG.txt"),
              p("wsj_spliced.scp")]
    with recorded_scores([]) as lls:
        run_verb(["latgen-faster", *decode, p("wsj_lats.npz"),
                  p("wsj_hyp.txt")], secs)
    launches = read_launches()
    verb_hyps = cli_train._read_text(p("wsj_hyp.txt"))
    # the recipe's own path on the same (int16-quantised) waves
    waves, rate = DataDir.load(p("wsj")).load_waves()
    same = synthetic.SyntheticCorpus(test.lexicon, test.word_probs, waves,
                                     test.transcripts, int(rate))
    t = time.perf_counter()
    lats = wsj.nnet_decode(am, wsj.compute_fbank_volumes(
        same, 36, device=dev, dither=0.0), hclg)
    recipe_s = time.perf_counter() - t
    recipe_hyps = {u: [tri.word_table.sym(int(w)) for w in
                       shortest_path(lat, 1.0, wsj.ACOUSTIC_SCALE)[1]]
                   for u, lat in lats.items()}
    # the same verb on the CPU (host lattice decode), its loglikes replayed
    t = time.perf_counter()
    with recorded_scores([]) as lls_cpu:
        assert cli.main(["latgen-faster", "--device=cpu", "--host-decode",
                         *decode, p("wsj_lats_cpu.npz"),
                         p("wsj_hyp_cpu.txt")]) == 0
    cpu_s = time.perf_counter() - t
    cpu_hyps = cli_train._read_text(p("wsj_hyp_cpu.txt"))
    ll_err = max(float(np.abs(a - b).max()) for a, b in zip(lls, lls_cpu))
    frames = sum(len(ll) for ll in lls)
    agree = sum(verb_hyps[u] == recipe_hyps[u] for u in recipe_hyps)
    log(f"cli cnn: phase 8's CNN (F = 64, {tri.trans_model.num_pdfs} pdfs) "
        f"through compute-fbank-feats -> add-deltas -> splice-feats -> "
        f"latgen-faster on its {len(test.waves)} test utterances ({frames} "
        f"frames): "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f" s; one-best words equal to wsj.nnet_decode's ({recipe_s:.3f} s) "
        f"on {agree} of {len(recipe_hyps)} utterances; loglikes card vs "
        f"--device cpu max |diff| {ll_err:.3g} (limit {LOGLIKE_ATOL}; the "
        f"CPU replay {cpu_s:.3f} s, words equal on "
        f"{sum(cpu_hyps[u] == verb_hyps[u] for u in verb_hyps)} of "
        f"{len(verb_hyps)}, not asserted); launches in the phase "
        f"{launches}")
    if (sorted(verb_hyps) != sorted(recipe_hyps)
            or agree != len(recipe_hyps) or len(lls) != len(lls_cpu)
            or not np.isfinite(ll_err) or ll_err > LOGLIKE_ATOL):
        raise AssertionError("the verbs' CNN decode disagrees with "
                             "wsj.nnet_decode or with the CPU replay")
    if min(launches["fbank_fft"], launches["conv_maxpool"]) <= 0:
        raise AssertionError(f"a kernel did not run in the cli phase: "
                             f"{launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"cli phase: {phase_s:.1f} s (limit {CLI_PHASE_S})")
    if phase_s > CLI_PHASE_S:
        raise AssertionError(f"the cli phase took {phase_s:.1f} s")
    return launches


def lattices_equal(a, b) -> bool:
    """Two lattice dicts with the same keys and, per key, the same states
    and arcs (labels and costs bit for bit)."""
    return sorted(a) == sorted(b) and all(
        (a[u].num_states, a[u].start) == (b[u].num_states, b[u].start)
        and all(np.array_equal(getattr(a[u], k), getattr(b[u], k))
                for k in ("state_time", "arc_src", "arc_dst", "arc_ilabel",
                          "arc_olabel", "arc_graph", "arc_acoustic",
                          "final_graph"))
        for u in a)


def kaldi_round_trip(npz, stem, secs):
    """``lattice-copy`` npz -> Kaldi-binary ark -> npz, twice: True when
    the second ark is byte for byte the first (the CompactLattice arcs
    survive the archive) and the two npz hold the same lattices, arc for
    arc; also returns the lattices read back."""
    ark1, ark2 = f"{stem}.1.ark", f"{stem}.2.ark"
    back1, back2 = f"{stem}.1.npz", f"{stem}.2.npz"
    for a, b in ((npz, ark1), (ark1, back1), (back1, ark2), (ark2, back2)):
        run_verb(["lattice-copy", a, b], secs)
    with open(ark1, "rb") as f, open(ark2, "rb") as g:
        same_ark = f.read() == g.read()
    lats = load_lattices(back1)
    return same_ark and lattices_equal(lats, load_lattices(back2)), lats


def best_paths(text):
    """``lattice-best-path`` stdout -> {utt: words}."""
    return {ln.split()[0]: ln.split()[1:] for ln in text.splitlines()
            if ln.strip()}


def lattice_phase(dev, tmp, test):
    """Phase 15: (a) the lattice verbs on latgen-faster's lattices of phase
    8's CNN (phase 14's files, the features redone in the phase), (b) the
    big graph on the card; returns the kernels' launches in the phase."""
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "cli")
    L = os.path.join(tmp, "lattice")
    os.makedirs(L)

    def p(*names):
        return os.path.join(d, *names)

    def q(name):
        return os.path.join(L, name)

    reset_launches()
    # ---- (a) the verbs on the CNN's lattices ------------------------------
    secs = {}
    for argv in (
            ["compute-fbank-feats", "--num-mel-bins=36", "--dither=0",
             p("wsj", "wav.scp"), q("fbank.ark")],
            ["add-deltas", q("fbank.ark"), q("deltas.ark")],
            ["splice-feats", f"--left-context={wsj.CONTEXT}",
             f"--right-context={wsj.CONTEXT}", q("deltas.ark"),
             q("spliced.ark"), f"--out-scp={q('spliced.scp')}"],
            ["latgen-faster", "--beam=60", "--max-active=2000",
             "--lattice-beam=8", f"--acoustic-scale={wsj.ACOUSTIC_SCALE}",
             f"--lang-dir={p('wsj_lang')}", p("cnn.mdl"), p("wsj_HCLG.txt"),
             q("spliced.scp"), q("lats.npz"), q("hyp.txt")]):
        run_verb(argv, secs)
    # the native Table reader, built on this machine, on the feature ark
    index = native_io.ArkIndex(q("fbank.ark"))
    feats = list(read_ark(q("fbank.ark")))
    native_ok = index.keys == [k for k, _ in feats] and all(
        np.array_equal(index.value(i), v) for i, (_, v) in enumerate(feats))
    lats = load_lattices(q("lats.npz"))
    utts = sorted(lats)
    hyps = cli_train._read_text(q("hyp.txt"))
    same_as_cli = sum(hyps[u] == h for u, h in cli_train._read_text(
        p("wsj_hyp.txt")).items() if u in hyps)
    words = f"--word-table={p('wsj_lang', 'words.txt')}"
    ac = f"--acoustic-scale={wsj.ACOUSTIC_SCALE}"
    best = best_paths(run_verb(["lattice-best-path", ac, words,
                                q("lats.npz")], secs))
    copy_ok, _ = kaldi_round_trip(q("lats.npz"), q("lats"), secs)
    text = run_verb(["lattice-copy", q("lats.npz")], secs)
    text_keys = [ln for ln in text.splitlines() if ln in lats]
    run_verb(["lattice-scale", ac, q("lats.npz"), q("scaled.npz")], secs)
    scaled = best_paths(run_verb(["lattice-best-path", words,
                                  q("scaled.npz")], secs))
    with open(q("unigram.arpa"), "w") as f:
        f.write(make_unigram_arpa(test.word_probs))
    for scale, src, dst in (("-1", "lats", "minus"), ("1", "minus", "back")):
        run_verb(["lattice-lmrescore", f"--scale={scale}", words,
                  q("unigram.arpa"), q(f"{src}.npz"), q(f"{dst}.npz")], secs)
    minus, back = load_lattices(q("minus.npz")), load_lattices(q("back.npz"))
    lm_words = lm_cost = 0
    lm_err = 0.0
    for u in utts:
        _, w0, c0 = shortest_path(lats[u], 1.0, wsj.ACOUSTIC_SCALE)
        _, w1, c1 = shortest_path(back[u], 1.0, wsj.ACOUSTIC_SCALE)
        lm_words += list(w0) == list(w1)
        lm_err = max(lm_err, abs(c1 - c0))
        lm_cost += abs(shortest_path(minus[u], 1.0, wsj.ACOUSTIC_SCALE)[2]
                       - c0) > LM_COST_ATOL
    outputs = {}
    for verb, extra in (("lattice-prune", ["--beam=4", ac]),
                        ("lattice-determinize", [ac]),
                        ("lattice-push", []), ("lattice-minimize", [])):
        run_verb([verb, *extra, q("lats.npz"), q(f"{verb}.npz")], secs)
        outputs[verb] = sorted(load_lattices(q(f"{verb}.npz")))
    for verb, extra in (("lattice-mbr-decode", [ac, words]),
                        ("lattice-nbest", ["--n=3", ac]),
                        ("lattice-to-post", [ac])):
        out = run_verb([verb, *extra, q("lats.npz")], secs)
        outputs[verb] = sorted({ln.split()[0].rsplit("-", 1)[0]
                                if verb == "lattice-nbest" else ln.split()[0]
                                for ln in out.splitlines() if ln.strip()})
    verbs_s = time.perf_counter() - t_phase
    arcs = [lats[u].num_arcs for u in utts]
    log(f"lattice verbs: latgen-faster on phase 8's CNN ({len(utts)} test "
        f"utterances, lattices of {min(arcs)}-{max(arcs)} arcs; one-best "
        f"equal to phase 14's on {same_as_cli} of {len(utts)}, not "
        f"asserted): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f" s; lattice-best-path = latgen-faster's one-best on "
        f"{sum(best.get(u) == hyps[u] for u in utts)} of {len(utts)}; "
        f"lattice-copy npz -> ark -> npz arc for arc: {copy_ok}; text for "
        f"{len(text_keys)} keys; lattice-scale then best path = best path "
        f"at the scale on {sum(scaled.get(u) == best.get(u) for u in utts)};"
        f" lmrescore -1 moved the one-best cost of {lm_cost}, -1 then +1 "
        f"gives back the one-best words on {lm_words}, cost max |diff| "
        f"{lm_err:.3g} (limit {LM_COST_ATOL}); every key out of "
        + ", ".join(f"{v} {len(k)}" for v, k in outputs.items())
        + f"; native ArkIndex on compute-fbank-feats' ark: {len(index)} "
        f"entries, equal to read_ark: {native_ok}; {verbs_s:.1f} s")
    if not (all(best.get(u) == hyps[u] and scaled.get(u) == best[u]
                for u in utts)
            and copy_ok and sorted(text_keys) == utts
            and lm_words == len(utts) and lm_cost == len(utts)
            and lm_err <= LM_COST_ATOL
            and all(k == utts for k in outputs.values())
            and native_ok and len(index) == len(utts) and sorted(hyps) == utts):
        raise AssertionError("a lattice verb's check failed")

    # ---- (b) the big graph on the card ------------------------------------
    big = big_graph(dev, q)
    launches = read_launches()
    phase_s = time.perf_counter() - t_phase
    log(f"lattice phase: {phase_s:.1f} s (limit {LATTICE_PHASE_S}); "
        f"launches in the phase {launches}")
    if min(launches["fbank_fft"], launches["conv_maxpool"]) <= 0:
        raise AssertionError(f"a kernel did not run in the lattice phase: "
                             f"{launches}")
    if phase_s > LATTICE_PHASE_S:
        raise AssertionError(f"the lattice phase took {phase_s:.1f} s")
    return launches, big


def dense_phase(dev, big):
    """Phase 15 (c): the dense exact search (``DenseViterbiDecoder``) on
    phase 15 (b)'s big graph; returns the kernels' launches in the phase
    (the search is plain PyTorch ops: none)."""
    t_phase = time.perf_counter()
    reset_launches()
    g, ll, lls = big["graph"], big["ll"], big["lls"]
    w_host, c_host = big["host"]
    audio_s = BIG_UTTS * BIG_FRAMES / 100.0
    dec = DenseViterbiDecoder(g, beam=1e9, max_active=0, acoustic_scale=1.0,
                              device=dev)
    ((tids, w, c),) = dec.decode_batch([ll])
    exact20 = (list(w) == list(w_host) and len(tids) == len(ll)
               and abs(c - c_host) <= max(BIG_COST_ABS,
                                          BIG_COST_REL * abs(c_host)))
    dec.release()               # the 20-frame histories
    runs = {}
    for name in ("captured", "warm", "eager"):
        if name == "eager":
            dec.release()       # the graphs' histories go first
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        caps = sum(dec.capture_seconds.values())
        t = time.perf_counter()
        paths = dec.decode_batch(lls, eager=name == "eager")
        torch.cuda.synchronize()
        runs[name] = dict(paths=paths, s=time.perf_counter() - t,
                          caps=sum(dec.capture_seconds.values()) - caps,
                          graphs=dict(dec.capture_seconds),
                          peak=torch.cuda.max_memory_allocated())
    cap_, eag = runs["captured"], runs["eager"]
    bad_eager = differing(cap_["paths"], eag["paths"])
    bad_warm = differing(cap_["paths"], runs["warm"]["paths"])
    # where the top-K kept no final state, its path ends on its cheapest
    # token, which the exact search's cheapest state bounds: the exact
    # search on the graph with no final state (its fallback)
    no_final = copy.copy(g)
    no_final.final = np.full_like(g.final, np.inf)
    nf = DenseViterbiDecoder(no_final, beam=1e9, max_active=0,
                             acoustic_scale=1.0, device=dev)
    any_paths = nf.decode_batch(lls)
    del nf
    exact = [d[2] if f else a[2] for d, f, a in zip(
        cap_["paths"], big["topk_final"], any_paths)]
    over = [b for b, (e, k) in enumerate(zip(exact, big["topk"]))
            if e > k[2] + BIG_COST_ABS]
    topk_err = [b for b, (d, k) in enumerate(zip(cap_["paths"], big["topk"]))
                if list(d[1]) != list(k[1])]
    hist = 2 * BIG_FRAMES * BIG_UTTS * g.num_states * 4
    phase_s = time.perf_counter() - t_phase
    launches = read_launches()
    log(f"dense search (DenseViterbiDecoder, beam 1e9, max_active 0, eps "
        f"depth {dec.eps_iters}; {gpu_line()}): 20 frames {len(w)} words, "
        f"cost {c:.4f} against the host exact Viterbi's {len(w_host)} "
        f"words, {c_host:.4f}: words equal and cost within rel "
        f"{BIG_COST_REL} / abs {BIG_COST_ABS}: {exact20}; {BIG_UTTS} x "
        f"{BIG_FRAMES} frames captured {cap_['s']:.3f} s with "
        f"{cap_['caps']:.3f} s of captures (RTF {cap_['s'] / audio_s:.4f}, "
        f"{(cap_['s'] - cap_['caps']) / audio_s:.4f} without; block graphs "
        f"{ {k: round(v, 3) for k, v in cap_['graphs'].items()} }), "
        f"replayed again {runs['warm']['s']:.3f} s (RTF "
        f"{runs['warm']['s'] / audio_s:.4f}), eager {eag['s']:.3f} s (RTF "
        f"{eag['s'] / audio_s:.4f}); histories {hist / 2**30:.2f} GiB; peak "
        f"max_memory_allocated captured {cap_['peak'] / 2**30:.2f} GiB, "
        f"eager {eag['peak'] / 2**30:.2f} GiB; rows whose (tids, words, "
        f"cost bits) differ: eager {bad_eager}, the second replay "
        f"{bad_warm}; rows whose top-K best path (beam 15, max_active 7000) "
        f"ends in a final state: {sum(big['topk_final'])} of {BIG_UTTS} "
        f"(not: {[b for b, f in enumerate(big['topk_final']) if not f]}); "
        f"rows whose exact cost (where the top-K kept no final state: the "
        f"exact search's cheapest state at the last frame) exceeds the "
        f"top-K's + {BIG_COST_ABS}: {over}; top-K search "
        f"errors (words differ from the exact search's): {len(topk_err)} "
        f"of {BIG_UTTS} {topk_err}; phase {phase_s:.1f} s (limit "
        f"{DENSE_PHASE_S})")
    if not exact20 or bad_eager or bad_warm or over:
        raise AssertionError("the dense search's checks failed")
    if phase_s > DENSE_PHASE_S:
        raise AssertionError(f"the dense search phase took {phase_s:.1f} s")
    return launches


def mode_b_phase(num_pdfs):
    """Phase 16: mode B (``make_replica_step``) on the card, MODE_B_REPLICAS
    replicas of the Librispeech net at DP_ROWS rows each, MODE_B_STEPS
    steps in the NG warm-up (every step refreshes), graphed and eager
    under deterministic cuDNN (``rank_check.replicas_graphs_vs_eager``):
    objfs, parameters and NG states bit-equal, the replicas diverged and
    one model after ``average_replicas``, the maxpool kernels launched;
    returns the phase's launches."""
    t = time.perf_counter()
    reset_launches()
    r = rank_check.replicas_graphs_vs_eager(
        libri_cfg(num_pdfs), MODE_B_REPLICAS, MODE_B_STEPS, DP_ROWS, 0.08,
        SEED)
    launches = read_launches()
    g, e = r["graphed"], r["eager"]
    med = lambda v: float(np.median(v[2:]))
    log(f"mode B (make_replica_step, {r['replicas']} replicas of the "
        f"Librispeech net, {num_pdfs} pdfs, {r['steps']} steps of "
        f"{r['rows']} rows each, every step an NG refresh; deterministic "
        f"cuDNN; {gpu_line()}; {time.perf_counter() - t:.1f} s): bit-equal "
        f"{r['same']}; replicas diverged {r['diverged']}, one model after "
        f"average_replicas {r['averaged_equal']}; ms an R-step graphed "
        f"{[round(x, 3) for x in g['ms']]} (median of steps 2-"
        f"{r['steps'] - 1}: {med(g['ms']):.3f}), R single eager steps "
        f"{[round(x, 3) for x in e['ms']]} (median {med(e['ms']):.3f}); "
        f"{len(g['captures'])} graphs captured in "
        f"{sum(g['captures'].values()):.3f} s; maxpool fwd/bwd graphed "
        f"{g['maxpool']} (warm-ups {g['warmup']}), eager {e['maxpool']}; "
        f"objf {r['objf'][0]:.4f} -> {r['objf'][1]:.4f}")
    if (not all(r["same"].values()) or not r["diverged"]
            or not r["averaged_equal"] or not g["captures"]
            or min(e["maxpool"]) <= 0 or min(g["maxpool"]) <= 0):
        raise AssertionError("mode B through the graphs failed its checks")
    return launches


def big_graph(dev, q):
    """Phase 15 (b): the big graph on the card; its files under ``q``."""
    t = time.perf_counter()
    g = make_big_graph(**BIG_GRAPH)
    P = BIG_GRAPH["num_pdfs"]
    n_arcs = len(g.e_src) + len(g.n_src)
    ll = sample_loglikes(g, P, T=20, seed=5)
    dec = topk_decoder.TopKDecoder(g, beam=60.0, max_active=16384,
                                   acoustic_scale=1.0, device=dev)
    ((tids, w_card, c_card),) = dec.decode_batch([ll])
    _, w_host, c_host = viterbi_decode(g, ll, acoustic_scale=1.0,
                                       beam=np.inf, max_active=0)
    exact_s = time.perf_counter() - t
    exact = (list(w_card) == list(w_host) and len(tids) == len(ll)
             and abs(c_card - c_host) <= max(BIG_COST_ABS,
                                             BIG_COST_REL * abs(c_host)))
    log(f"big graph: make_big_graph({BIG_GRAPH}) {g.num_states} states, "
        f"{n_arcs} arcs; 20 frames at beam 60, max_active 16384 on the "
        f"card: {len(w_card)} words, cost {c_card:.4f}; host exact Viterbi "
        f"{len(w_host)} words, cost {c_host:.4f}; words equal and cost "
        f"within rel {BIG_COST_REL} / abs {BIG_COST_ABS}: {exact} "
        f"({exact_s:.2f} s)")
    if g.num_states < 100_000 or n_arcs < 1_000_000 or not exact:
        raise AssertionError("the big-graph exactness check failed")
    del dec
    lls = [sample_loglikes(g, P, T=BIG_FRAMES, seed=s)
           for s in range(BIG_UTTS)]
    audio_s = BIG_UTTS * BIG_FRAMES / 100.0
    # eager, then captured (its captures are in its first calls), each
    # on a fresh decoder so that each run's peak is its own
    runs = {}
    for name in ("eager", "captured"):
        dec = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        dec = topk_decoder.TopKDecoder(g, beam=15.0, max_active=7000,
                                       acoustic_scale=1.0, lattice_beam=8.0,
                                       lattice_arcs_per_frame=None,
                                       device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        with (eager_search() if name == "eager"
              else contextlib.nullcontext()), lattice_probes(None) as pr:
            t = time.perf_counter()
            paths = dec.decode_batch(lls)
            torch.cuda.synchronize()
            best_s = time.perf_counter() - t
            best_caps = dict(dec.capture_seconds)
            final = dec.last_reached_final
            t = time.perf_counter()
            big_lats = dec.decode_batch_lattice(lls, determinize=False)
            torch.cuda.synchronize()
            lat_s = time.perf_counter() - t
        runs[name] = dict(paths=paths, lats=big_lats, best_s=best_s,
                          lat_s=lat_s, probe=pr, overflow=dec.last_overflow,
                          peak=torch.cuda.max_memory_allocated(),
                          caps=dict(dec.capture_seconds),
                          best_caps=best_caps, final=final)
    cap_, eag = runs["captured"], runs["eager"]
    paths, big_lats, best_s, lat_s, peak = (
        cap_[k] for k in ("paths", "lats", "best_s", "lat_s", "peak"))
    dropped, o_frames = cap_["overflow"]
    bad_eager = differing(paths, eag["paths"])
    bad_host = differing(paths, host_best_paths(dec, lls))
    same_lats = lattices_equal(dict(enumerate(big_lats)),
                               dict(enumerate(eag["lats"])))
    best_cap = sum(cap_["best_caps"].values())
    lat_cap = sum(cap_["caps"].values()) - best_cap
    log(f"big graph search on the card, captured vs eager ({BIG_UTTS} x "
        f"{BIG_FRAMES} frames): best path {best_s:.3f} s with "
        f"{best_cap:.3f} s of captures (RTF {best_s / audio_s:.4f}, "
        f"{(best_s - best_cap) / audio_s:.4f} without) vs eager "
        f"{eag['best_s']:.3f} s (RTF {eag['best_s'] / audio_s:.4f}); "
        f"lattice {lat_s:.3f} s with {lat_cap:.3f} s of captures (RTF "
        f"{lat_s / audio_s:.4f}, {(lat_s - lat_cap) / audio_s:.4f} "
        f"without) vs eager {eag['lat_s']:.3f} s (RTF "
        f"{eag['lat_s'] / audio_s:.4f}); "
        + search_line("captured", cap_["probe"]["s"], cap_["probe"]["calls"],
                      [{k: v for k, v in cap_["caps"].items()
                        if k[0] == "frames"}], cap_["peak"])
        + "; " + search_line("eager", eag["probe"]["s"],
                             eag["probe"]["calls"], [], eag["peak"])
        + f"; each capture's s "
        f"{ {str(k): round(v, 3) for k, v in cap_['caps'].items()} }; "
        f"rows whose best path (tids, words, cost bits) differs: eager "
        f"{bad_eager}, host _best_path on the fetched histories "
        f"{bad_host}; lattices equal arc for arc: {same_lats}; eager "
        f"calls in the captured run {cap_['probe']['eager']}; eager "
        f"overflow {eag['overflow']}")
    if (bad_eager or bad_host or not same_lats or cap_["probe"]["eager"]
            or not eag["probe"]["eager"] or eag["overflow"] != (0, 0)):
        raise AssertionError("the big graph's captured and eager searches "
                             "disagree")
    agree = sum(list(shortest_path(lat, 1.0, 1.0)[1]) == list(w)
                for lat, (_, w, _) in zip(big_lats, paths))
    big = {f"big{i:02d}": big_lats[i] for i in range(BIG_COPY_UTTS)}
    save_lattices(q("big.npz"), big)
    big_secs = {}
    big_copy_ok, big_back = kaldi_round_trip(q("big.npz"), q("big"),
                                             big_secs)
    big_words_ok = all(
        list(shortest_path(big_back[u], 1.0, 1.0)[1])
        == list(shortest_path(big[u], 1.0, 1.0)[1]) for u in big)
    run_verb(["lattice-determinize", "--acoustic-scale=1.0", q("big.npz"),
              q("big_det.npz")], big_secs)
    det = load_lattices(q("big_det.npz"))
    log(f"big graph decode ({BIG_UTTS} x {BIG_FRAMES} frames, {audio_s} s "
        f"of audio; beam 15, max_active 7000, lattice beam 8, acoustic "
        f"scale 1.0; lattice_arcs_per_frame {dec.A_lat}): decoder built "
        f"{build_s:.3f} s; best path {best_s:.3f} s (RTF "
        f"{best_s / audio_s:.4f}); lattice, determinize=False, "
        f"{lat_s:.3f} s (RTF {lat_s / audio_s:.4f}), "
        f"{sum(l.num_arcs for l in big_lats)} lattice arcs, overflow "
        f"{dropped} arcs dropped on {o_frames} frames; lattice one-best = "
        f"best path on {agree} of {BIG_UTTS} (not asserted); peak "
        f"torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB; first "
        f"{BIG_COPY_UTTS} lattices through lattice-copy ark and back arc "
        f"for arc: {big_copy_ok}, one-best words kept: {big_words_ok}; "
        f"lattice-determinize: {sum(l.num_arcs for l in det.values())} "
        f"arcs; " + ", ".join(f"{k} {v:.3f}" for k, v in big_secs.items())
        + " s")
    if (dropped != 0 or not big_copy_ok or not big_words_ok
            or sorted(det) != sorted(big)
            or any(l.num_arcs == 0 for l in det.values())):
        raise AssertionError("the big-graph lattice checks failed")
    return {"graph": g, "ll": ll, "host": (w_host, c_host), "lls": lls,
            "topk": paths, "topk_final": cap_["final"].tolist()}


def stream_rows(stream, rows):
    """``rows`` fed to ``stream`` in the frame counts of STREAM_CHUNK_S
    chunks; its final (tids, words, cost)."""
    stream.reset()
    step = max(1, int(round(STREAM_CHUNK_S * 100)))
    for i in range(0, len(rows), step):
        stream.advance(rows[i:i + step])
    stream.finalize()
    return stream.best_path()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    t_kernels = time.perf_counter()
    bench = F.FbankOptions()                        # 16 kHz, 23 bins
    bench.frame_opts.dither = 1.0
    nsamp = 11999 * bench.frame_opts.window_shift \
        + bench.frame_opts.window_size              # 12000 frames
    wave = (np_rng(SEED, "bench_wave").normal(size=nsamp) * 1000
            ).astype(np.float32)
    fbank_case("bench-16k", bench, wave, dev)
    # round_to_power_of_two off: N = ws = 400, the mixed-radix kernel's
    bench_n400 = copy.deepcopy(bench)
    bench_n400.frame_opts.round_to_power_of_two = False
    t = time.perf_counter()
    fb_n400 = fbank_case("bench-16k-n400", bench_n400, wave, dev)
    mixed_s = time.perf_counter() - t
    slice_opts = F.FbankOptions()
    slice_opts.frame_opts.samp_freq = float(corpus.sample_rate)
    slice_opts.mel_opts.num_bins = 36
    utt0 = sorted(corpus.waves)[0]
    fb = fbank_case("wsj-8k", slice_opts, corpus.waves[utt0], dev)
    slice_n200 = copy.deepcopy(slice_opts)                 # N = ws = 200
    slice_n200.frame_opts.round_to_power_of_two = False
    t = time.perf_counter()
    fb_n200 = fbank_case("wsj-8k-n200", slice_n200, corpus.waves[utt0], dev)
    mixed_s += time.perf_counter() - t
    mfcc_opts = F.MfccOptions()
    mfcc_opts.frame_opts.samp_freq = float(corpus.sample_rate)
    fb_mfcc = fbank_case("mfcc-8k", F.mfcc_fbank_options(mfcc_opts),
                         corpus.waves[utt0], dev)
    # one streaming chunk (STREAM_CHUNK_S of 8 kHz audio: 18 frames)
    chunk = corpus.waves[utt0][:int(STREAM_CHUNK_S * corpus.sample_rate)]
    fb_stream = fbank_case("stream-8k", slice_opts, chunk, dev)
    fb_stream_mfcc = fbank_case("mfcc-stream-8k",
                                F.mfcc_fbank_options(mfcc_opts), chunk, dev)
    cb = conv_case("bench-F128", ConvnetConfig(), 4096, dev)
    cv = conv_case("wsj-F64", ConvnetConfig(num_filters=64), 4096, dev)
    # the rows AmNnet.loglikes pads a streaming chunk to
    cv512 = conv_case("wsj-F64 512 rows", ConvnetConfig(num_filters=64), 512,
                      dev)
    # the Switchboard recipe's F = 48 (the kernel pads it to 64 filters),
    # at loglikes_batch's 4096 rows and AmNnet.loglikes' 512
    cv48 = conv_case("swbd-F48", ConvnetConfig(num_filters=48), 4096, dev)
    cv48_512 = conv_case("swbd-F48 512 rows", ConvnetConfig(num_filters=48),
                         512, dev)
    for cname, c in (("bench-F128", cb), ("wsj-F64", cv),
                     ("wsj-F64 512 rows", cv512), ("swbd-F48", cv48),
                     ("swbd-F48 512 rows", cv48_512)):
        log(f"conv {cname}: wgmma (bf16) {c['bf16']['ms']:.4f} ms = "
            f"{100 * c['bf16']['bound_ms'] / c['bf16']['ms']:.1f}% of its "
            f"{c['bf16']['bound_ms']:.4f} ms bound, cuDNN bf16 yardstick "
            f"{c['bf16']['library_ms']:.4f} ms; CUDA cores (f32) "
            f"{c['f32']['ms']:.4f} ms")
    pools = {}
    for pname, shape, rows in (("bench-F128", (8, 30, 128, 2, 3, 1), 4096),
                               ("wsj-F64", (8, 30, 64, 2, 3, 1), 256),
                               ("swbd-F48", (8, 30, 48, 2, 3, 1), 256),
                               ("pool_c=2", (8, 30, 64, 2, 3, 2), 256)):
        for dtype in (torch.float32, torch.bfloat16):
            r = maxpool_case(pname, shape, rows, dtype, dev)
            pools[r["name"]] = r
    mp_bench = pools["bench-F128 f32"]
    log(f"kernel phase: {time.perf_counter() - t_kernels:.1f} s (of it the "
        f"round_to_power_of_two=False fbank cases {mixed_s:.1f} s)")

    # ---- 2. slice phase -----------------------------------------------
    am = wsj_model(num_pdfs, dev)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = wsj.decode(am, corpus, hclg, lang.word_table, seed=SEED)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t
    launches = {"fbank_fft": fbank_frames.launches,
                "conv_maxpool": conv2d_maxpool.launches}
    off_path = {k: v for k, v in read_launches().items() if k in (
        "conv_maxpool_f32", "fbank_table", "fbank_fft_mixed")}
    lls = res["loglikes"]
    frames = sum(v.shape[0] for v in lls.values())
    log(f"slice: {len(lls)} utterances, {frames} frames, launches "
        f"{launches} (off the path {off_path}), wsj.decode "
        f"{slice_s:.3f} s (fbank + scoring + search + WER), WER "
        f"{res['wer']:.2f}% ({res['errors']} errors / {res['words']} "
        f"words; random weights, not asserted)")
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

    # ---- 4. lattice slice -----------------------------------------------
    lattice_slice(am, am_cpu, corpus, hclg, lang.word_table, dec)

    # ---- 5. training slice ----------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tvols = wsj.compute_fbank_volumes(corpus, seed=SEED, device=dev)
        t2p = lang.trans_model.trans_id_to_pdf_array()
        ali = {u: align_equal(CompiledGraph(compile_training_graph(
            lang, corpus.transcripts[u]), t2p), v.shape[0])
            for u, v in tvols.items()}
        prep_s = time.perf_counter() - t
        with counted_eager_steps() as eager_calls:
            am_t, train_s, objfs, last, _ = train_slice(
                tvols, ali, t2p, num_pdfs, dev, os.path.join(tmp, "card"))
        train_launches = {"fbank_fft": fbank_frames.launches,
                          "maxpool_fwd_vec": mp.maxpool3d.launches,
                          "maxpool_bwd": mp.maxpool3d_backward.launches}
        train_graphs = am_t.nnet.capture_seconds
        scalar_launches = {
            "maxpool_fwd_scalar": mp.maxpool3d_scalar.launches,
            "maxpool_bwd_scalar": mp.maxpool3d_backward_scalar.launches}
        egs_train, egs_valid = wsj.split_valid(
            wsj.make_cnn_egs(tvols, ali, t2p, wsj.CONTEXT, wsj.CONTEXT, SEED))
        frames = TRAIN_EPOCHS * len(egs_train)
        net0 = make_convnet(wsj.model_config(36, num_pdfs), device=dev)
        net0.init(torch_generator(SEED, "init"))
        lp0, lp = valid_logprob(net0, egs_valid), valid_logprob(
            am_t.nnet, egs_valid)
        log(f"train: {len(tvols)} utterances, {len(egs_train)} train / "
            f"{len(egs_valid)} valid egs, {TRAIN_EPOCHS} epochs, "
            f"{len(objfs)} steps of 256; fbank volumes + equal alignments "
            f"{prep_s:.3f} s; wsj.train {train_s:.3f} s "
            f"({frames / 100.0 / train_s:.1f} audio-s/s) through "
            f"Nnet.train_steps' CUDA graphs ({captures(am_t.nnet)}; "
            f"eager-loop calls {len(eager_calls)}); launches "
            f"{train_launches} (scalar kernels {scalar_launches}); "
            f"objf step 0 {objfs[0]:.4f} -> last "
            f"{objfs[-1]:.4f}; valid logprob {lp0:.4f} (initial) -> "
            f"{lp:.4f}")
        if min(train_launches.values()) <= 0:
            raise AssertionError(f"a kernel did not run in the training: "
                                 f"{train_launches}")
        if eager_calls or not train_graphs:
            raise AssertionError("the training did not run through the "
                                 "CUDA graphs")
        if not lp > lp0:
            raise AssertionError("training did not raise the valid logprob")
        conv2d_maxpool.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res_t = wsj.decode(am_t, corpus, hclg, lang.word_table, seed=SEED)
        torch.cuda.synchronize()
        dec_launches = conv2d_maxpool.launches
        log(f"train decode: wsj.decode {time.perf_counter() - t:.3f} s, "
            f"conv_maxpool launches {dec_launches}, WER of the trained "
            f"model on its own training utterances {res_t['wer']:.2f}% "
            f"({res_t['errors']} errors / {res_t['words']} words; not "
            f"asserted)")
        if dec_launches <= 0:
            raise AssertionError("conv_maxpool did not run in the decode")

        # ---- 5b. the same training graphed and eager, bit for bit -------
        train_bit_check(tvols, ali, t2p, num_pdfs, dev, tmp)

        # ---- 6. training replay on the CPU --------------------------------
        am_c, cpu_s, objfs_c, last_c, _ = train_slice(
            tvols, ali, t2p, num_pdfs, "cpu", os.path.join(tmp, "cpu"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_err = float(np.abs(objfs - objfs_c).max())
    rel = max(float(np.linalg.norm(a[k] - b[k]) / max(
        np.linalg.norm(b[k]), 1e-30)) for a, b in zip(last, last_c)
        for k in a)
    lp_c = valid_logprob(am_c.nnet, egs_valid)
    log(f"train replay on cpu ({cpu_s:.1f} s): per-step objf max |diff| "
        f"{step_err:.3g} (limit {OBJF_STEP_ATOL}), pre-combine params max "
        f"relative Frobenius diff {rel:.3g} (limit {PARAM_REL}), final "
        f"valid logprob {lp:.5f} vs {lp_c:.5f} (limit {VALID_ATOL})")
    if (len(objfs) != len(objfs_c) or step_err > OBJF_STEP_ATOL
            or rel > PARAM_REL or abs(lp - lp_c) > VALID_ATOL):
        raise AssertionError("the card's training disagrees with the CPU "
                             "replay")

    # ---- 7. train-step time, eager and graphed ---------------------------
    bench_net = make_convnet(ConvnetConfig(), fused=True, device=dev)
    bench_net.init(torch_generator(SEED, "bench_train"))
    recipe_net = make_convnet(wsj.model_config(36, num_pdfs), device=dev)
    recipe_net.init(torch_generator(SEED, "recipe_train"))
    mp_ms = mp_bench["arg_ms"] + mp_bench["bwd_ms"]
    gpu = gpu_line()
    step_ms = {}
    for cell, net_, rows in (("bench", bench_net, BENCH_TRAIN_ROWS),
                             ("recipe", recipe_net, 256)):
        r = step_ms[cell] = train_step_ms(net_, rows, dev, f"{cell}_train")
        log(f"train step {cell} ({'ConvnetConfig(), F = 128' if cell == 'bench' else 'the WSJ CNN, F = 64'}, "
            f"mb {rows}, f32 storage, groups of 8; {gpu}): eager "
            f"{r['eager_warmup_ms']:.3f} ms a step in the NG warm-up, "
            f"{r['eager_steady_ms']:.3f} ms steady (device busy "
            f"{100 * r['eager_steady_busy']:.1f}%); graphed "
            f"{r['graphed_warmup_ms']:.3f} ms warm-up, "
            f"{r['graphed_steady_ms']:.3f} ms steady (device busy "
            f"{100 * r['graphed_steady_busy']:.1f}%); {r['captures']}")
    log(f"train step bench: maxpool forward with argmax + backward "
        f"{mp_ms:.4f} ms = "
        f"{100 * mp_ms / step_ms['bench']['graphed_steady_ms']:.1f}% of the "
        f"graphed steady step")
    del bench_net, recipe_net

    # ---- 8. the recipe end to end -----------------------------------------
    mfcc_check(corpus, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        recipe_corpus = wsj.make_corpus(RECIPE_UTTS, SEED)
        recipe_launches, mfcc_n, _ = recipe_phase(dev, tmp, recipe_corpus)

        # ---- 9. streaming on phase 8's artifacts --------------------------
        t = time.perf_counter()
        stream_launches = streaming_phase(dev, os.path.join(tmp, "wsj"), tmp,
                                          wsj.split_corpus(recipe_corpus)[2])
        log(f"streaming phase: {time.perf_counter() - t:.1f} s")

        # ---- 13. MMI on phase 8's artifacts (before they go) -------------
        mmi_launches = mmi_phase(dev, os.path.join(tmp, "wsj"), tmp,
                                 recipe_corpus.word_probs)

        # ---- 14. the command-line verbs, on phase 8's artifacts too ----
        cli_launches = cli_phase(dev, os.path.join(tmp, "wsj"), tmp,
                                 wsj.split_corpus(recipe_corpus)[2])

        # ---- 15. the lattice layer, on phase 14's files, and the big graph
        lattice_launches, big = lattice_phase(
            dev, tmp, wsj.split_corpus(recipe_corpus)[2])
        dense_launches = dense_phase(dev, big)
        del big
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 10. the Switchboard recipe ---------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t = time.perf_counter()
        swbd_launches = swbd_phase(dev, tmp)
        log(f"swbd phase: {time.perf_counter() - t:.1f} s")

        # ---- 11. the RM recipe ----------------------------------------
        t = time.perf_counter()
        rm_launches = rm_phase(dev, tmp)
        log(f"rm phase: {time.perf_counter() - t:.1f} s")

        # ---- 12. the Librispeech recipe, then two ranks on the card ----
        t = time.perf_counter()
        libri_launches, libri = librispeech_phase(dev, tmp)
        nccl_graph_phase(libri["tree_leaves"])
        two_rank_phase(libri["tree_leaves"])
        mode_b_launches = mode_b_phase(libri["tree_leaves"])
        log(f"librispeech phase: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_phase = {
        "slice": {**launches, **off_path},
        "train": {**train_launches, **scalar_launches},
        "recipe": recipe_launches, "recipe_mfcc_stage": {"fbank_fft": mfcc_n},
        **stream_launches, "swbd": swbd_launches, "rm": rm_launches,
        "librispeech": libri_launches, "mmi": mmi_launches,
        "cli": cli_launches, "lattice": lattice_launches,
        "dense": dense_launches, "mode_b": mode_b_launches}

    def entry(name, source, replaces, n, r, pre=""):
        return {"name": name, "route": "cuda",
                "source": f"kaldi_cnn_tpu_torch/csrc/{source}",
                "replaces": f"kaldi_cnn_tpu/ops/{replaces}",
                "launches": n, "max_abs_err": r["max_abs_err"],
                "ms": r[f"{pre}ms"], "plain_ms": r[f"{pre}plain_ms"],
                "bound_ms": r.get(f"{pre}bound_ms"),
                "bound_by": r.get("bound_by", "bytes"),
                "library_ms": r.get(f"{pre}library_ms"),
                "graph_ms": r.get(f"{pre}graph_ms"),
                "library_graph_ms": r.get(f"{pre}library_graph_ms"),
                "launches_by_phase": {p: c[name] for p, c in
                                      by_phase.items() if name in c}}

    # maxpool at the training slice's shape (8x30x64, f32, 256 rows, the
    # argmax kept); the error is the largest over every maxpool case
    mp_wsj = dict(pools["wsj-F64 f32"])
    mp_wsj["max_abs_err"] = max(r["max_abs_err"] for r in pools.values())
    kernels = [
        entry("fbank_fft", "fbank.cu", "fbank_pallas.py:63",
              recipe_launches["fbank_fft"], fb),
        entry("fbank_table", "fbank.cu", "fbank_pallas.py:63",
              recipe_launches["fbank_table"], fb["table"]),
        entry("fbank_fft_mixed", "fbank.cu", "fbank_pallas.py:63",
              recipe_launches["fbank_fft_mixed"], fb_n400),
        entry("conv_maxpool", "conv_maxpool.cu", "conv_pallas.py:43",
              recipe_launches["conv_maxpool"], cv["bf16"]),
        entry("conv_maxpool_f32", "conv_maxpool.cu", "conv_pallas.py:43",
              recipe_launches["conv_maxpool_f32"], cv["f32"]),
        entry("maxpool_fwd_vec", "maxpool.cu", "maxpool_pallas.py:43",
              recipe_launches["maxpool_fwd_vec"], mp_wsj, "arg_"),
        entry("maxpool_fwd_scalar", "maxpool.cu", "maxpool_pallas.py:43",
              recipe_launches["maxpool_fwd_scalar"], mp_wsj, "sc_arg_"),
        entry("maxpool_bwd", "maxpool.cu", "maxpool_pallas.py:43",
              recipe_launches["maxpool_bwd"], mp_wsj, "bwd_"),
        entry("maxpool_bwd_scalar", "maxpool.cu", "maxpool_pallas.py:43",
              recipe_launches["maxpool_bwd_scalar"], mp_wsj, "sc_bwd_"),
    ]
    fbank_keys = ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms")
    # the mixed-radix kernel at 8 kHz (N 200), and the table kernel at its
    # two sizes, the ones round_to_power_of_two=False gave it before
    kernels[2]["wsj_8k_n200"] = {k: fb_n200[k] for k in fbank_keys}
    kernels[2]["max_abs_err"] = max(fb_n400["max_abs_err"],
                                    fb_n200["max_abs_err"])
    kernels[1]["bench_16k_n400"] = {k: fb_n400["table"][k]
                                    for k in fbank_keys}
    kernels[1]["wsj_8k_n200"] = {k: fb_n200["table"][k] for k in fbank_keys}
    # the fbank kernel at the MFCC's shape (23 bins, the energy kept)
    kernels[0]["mfcc_8k"] = {k: fb_mfcc[k] for k in (
        "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms")}
    # and at one streaming chunk (fbank volumes' 36 bins, the MFCC's 23)
    for key, r in (("stream_8k", fb_stream),
                   ("mfcc_stream_8k", fb_stream_mfcc)):
        kernels[0][key] = {k: r[k] for k in (
            "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
            "host_us")}
    kernels[0]["max_abs_err"] = max(fb["max_abs_err"],
                                    fb_mfcc["max_abs_err"],
                                    fb_stream["max_abs_err"],
                                    fb_stream_mfcc["max_abs_err"])
    # the wgmma conv at a streaming chunk's 512 rows
    kernels[3]["wsj_f64_512"] = {k: cv512["bf16"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
        "library_graph_ms")}
    kernels[3]["max_abs_err"] = max(cv["bf16"]["max_abs_err"],
                                    cv512["bf16"]["max_abs_err"],
                                    cv48["bf16"]["max_abs_err"],
                                    cv48_512["bf16"]["max_abs_err"])
    kernels[4]["max_abs_err"] = max(cv["f32"]["max_abs_err"],
                                    cv48["f32"]["max_abs_err"])
    # the Switchboard shapes: conv at F = 48 (4096 and 512 rows), maxpool
    # on its 8x30x48 output at the minibatch's 256 rows (f32 and bf16)
    conv_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "library_graph_ms")
    kernels[3]["swbd_f48"] = {k: cv48["bf16"][k] for k in conv_keys}
    kernels[3]["swbd_f48_512"] = {k: cv48_512["bf16"][k] for k in conv_keys}
    kernels[4]["swbd_f48"] = {k: cv48["f32"][k] for k in conv_keys}
    # and the backwards at the bench shape too (4096 rows of 8x30x128)
    for i, pre in ((5, "arg_"), (6, "sc_arg_"), (7, "bwd_"), (8, "sc_bwd_")):
        cells = ("swbd-F48", "bench-F128") if pre.endswith("bwd_") else (
            "swbd-F48",)
        for cell in cells:
            for mode in ("f32", "bf16"):
                r = pools[f"{cell} {mode}"]
                key = cell.lower().replace("-", "_")
                kernels[i][f"{key}_{mode}"] = {
                    "max_abs_err": r["max_abs_err"],
                    **{k: r[f"{pre}{k}"] for k in (
                        "ms", "graph_ms", "plain_ms", "bound_ms",
                        "library_ms", "library_graph_ms")}}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
