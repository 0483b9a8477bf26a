"""The Librispeech-960h-style configuration: the CNN acoustic model
trained data-parallel over ranks with periodic model averaging (twin of
``kaldi_cnn_tpu/recipes/librispeech.py``; ref: BASELINE.json config
"Librispeech 960h CNN, multi-host data-parallel + model averaging";
upstream egs/librispeech/s5 driven through queue.pl, here the
``parallel/multihost`` driver).

The WSJ pipeline with the scaling parts: one process a device in a
``torch.distributed`` group (world size 1 unless a coordinator joins
more), utterance-list sharding per process, each process's egs streamed
from its own on-disk store, the train step all-reducing over the ranks
(mode A) or replicas averaged every ``average_every`` steps, and the
dev/test lattice decode split over the ranks.

Three things differ from the JAX recipe by design, so that the ranks
train one model:
  - the GMM bootstrap (MFCC, mono -> triphone deltas) runs on rank 0 on
    the WHOLE training set and is broadcast, where each JAX process
    bootstraps its own shard and gets its own tree (and so its own
    ``num_pdfs`` and output layer);
  - the pdf counts behind the priors are summed over the ranks, where
    each JAX process counts its own shard;
  - rank k writes its egs under ``egs_dir/rank{k}``, where every JAX
    process writes the one ``egs_dir``.

Run on the card: ``python -m kaldi_cnn_tpu_torch.recipes.librispeech``
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from kaldi_cnn_tpu_torch.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu_torch.core.mesh import all_reduce, broadcast_object
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import shortest_path
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import decode_utterances
from kaldi_cnn_tpu_torch.gmm.train import (
    DeltasTrainOptions, MonoTrainOptions, train_deltas, train_mono)
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.parallel.multihost import (
    MultihostConfig, initialize, shard_utterances, train_multihost)
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.recipes.rm import score_sweep
from kaldi_cnn_tpu_torch.recipes.wsj import (
    compute_fbank_volumes, make_cnn_egs, splice_volume,
    write_cnn_egs_sharded)
from kaldi_cnn_tpu_torch.recipes.yesno import compute_features

logger = get_logger(__name__)

NUM_BINS, LEFT, RIGHT = 36, 5, 5


def bootstrap(mfcc: Dict[str, np.ndarray], transcripts, lang: Lang):
    """The recipe's GMM bootstrap on the host: mono (18 iterations, 300
    Gaussians) -> triphone deltas (12 iterations, 800 Gaussians, 300
    leaves).  Returns train_deltas' (am, alignments, tri Lang)."""
    am0, ali0 = train_mono(mfcc, transcripts, lang,
                           MonoTrainOptions(num_iters=18, totgauss=300))
    return train_deltas(
        mfcc, transcripts, lang, ali0, lang.trans_model,
        DeltasTrainOptions(num_iters=12, totgauss=800, max_leaves=300))


def nnet_decode(am, volumes: Dict[str, np.ndarray], hclg: CompiledGraph,
                group=None):
    """The recipe's lattice decode: the volumes spliced +-5 and scored in
    one padded stream on the model's device (``AmNnet.loglikes_batch``,
    the fused conv+maxpool kernel on the card), then the batched top-K
    lattice search at acoustic scale 0.1, beam 60, lattice beam 8 and
    max_active 2000, the utterances split over ``group``'s ranks
    (decoder-state parallelism; every rank gets every lattice)."""
    world = dist.get_world_size(group) if group is not None else 1
    lls = am.loglikes_batch(
        {utt: splice_volume(v, LEFT, RIGHT) for utt, v in volumes.items()})
    return decode_utterances(hclg, lls, acoustic_scale=0.1, beam=60.0,
                             lattice_beam=8.0, max_active=2000,
                             lattice_arcs_per_frame=None,
                             batch_size=max(8, world),
                             device=am.nnet.device, group=group)


def make_corpus(num_utts: int = 200, seed: int = 53, eval_utts: int = 0,
                corpus=None):
    """``run``'s (train, dev, test).  Without a corpus: ``num_utts``
    synthetic digit strings of 2-5 words at uniform word probabilities.
    With ``eval_utts > 0`` and no corpus given, a synthetic eval corpus
    of that many utterances (seed + 9001) is halved into dev and test
    and the whole corpus trains; otherwise 15 % test, then 10 % of the
    rest dev."""
    synthetic_corpus = corpus is None
    if corpus is None:
        lex = synthetic.digits_lexicon()
        wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
        corpus = synthetic.make_corpus(lex, wp, num_utts, 2, 5, seed)
    if eval_utts > 0 and synthetic_corpus:
        eval_corpus = synthetic.make_corpus(
            corpus.lexicon, corpus.word_probs, eval_utts, 2, 5, seed + 9001)
        dev, test = eval_corpus.split(0.5)
        return corpus, dev, test
    train, test = corpus.split(0.15)
    train, dev = train.split(0.1)
    return train, dev, test


def run(
    num_utts: int = 200,
    seed: int = 53,
    nnet_epochs: int = 25,
    num_filters: int = 48,
    average_every: int = 0,
    mh: Optional[MultihostConfig] = None,
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
    egs_dir: Optional[str] = None,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    eval_utts: int = 0,
    device="cuda",
) -> Dict:
    """The whole recipe on ``device`` as one rank of ``mh``'s process
    group (the JAX ``run``'s arguments, stage names and result keys).

    A process group that is not initialized is started by
    ``multihost.initialize`` (NCCL on the card, gloo on the CPU; world
    size 1 without a coordinator) and destroyed at the end.
    egs_dir: the root of the on-disk egs stores (ref:
    steps/nnet2/get_egs.sh), rank k's under ``rank{k}``; without one
    they go under ``exp_dir/egs``, else to a temporary directory removed
    at the end.  exp_dir/stage: stage-guarded execution of rank 0's
    "gmm_bootstrap" and "egs_store" (see ``wsj.run``).  eval_utts > 0:
    dev/test come from a dedicated eval corpus of that many utterances
    (disjoint seed) while the whole main corpus trains.

    Returns ``wer_details`` on test plus ``dev_wer``, ``point``,
    ``train_audio_ss``, ``num_devices`` (the ranks), ``backend``,
    ``tree_leaves``, ``graph_states`` and ``seconds`` (stage -> wall
    seconds), the same on every rank."""
    device = torch.device(device)
    torch.zeros(1, device=device)      # no card: raise before any work
    mh = mh or MultihostConfig(average_every=average_every)
    own_group = not dist.is_initialized()
    mesh = initialize(mh, device)
    try:
        return _run(mesh, mh, num_utts, seed, nnet_epochs, num_filters,
                    metrics, corpus, egs_dir, exp_dir, stage, eval_utts)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(mesh, mh, num_utts, seed, nnet_epochs, num_filters, metrics,
         corpus, egs_dir, exp_dir, stage, eval_utts) -> Dict:
    from kaldi_cnn_tpu_torch.core.stages import make_runner
    from kaldi_cnn_tpu_torch.models.factory import (ConvnetConfig,
                                                    make_convnet)
    from kaldi_cnn_tpu_torch.models.nnet import AmNnet
    from kaldi_cnn_tpu_torch.train.sharded_egs import StreamingEgsBatcher
    from kaldi_cnn_tpu_torch.train.trainer import TrainConfig

    dev_ = mesh.device
    rank, world = dist.get_rank(), mesh.size
    logger.info("mesh: %d ranks (%s), process %d/%d", world,
                dist.get_backend(), mh.process_id, mh.num_processes)
    sr = make_runner(exp_dir if rank == 0 else None, stage)

    train, dev, test = make_corpus(num_utts, seed, eval_utts, corpus)
    lex, wp = train.lexicon, train.word_probs

    # per-rank utterance shard (ref: utils/split_data.sh)
    local_utts = set(shard_utterances(list(train.waves), mh))
    train_local = synthetic.SyntheticCorpus(
        lex, wp, {u: train.waves[u] for u in local_utts},
        {u: train.transcripts[u] for u in local_utts},
        train.sample_rate)
    logger.info("corpus: %d local train / %d dev / %d test",
                len(train_local.waves), len(dev.waves), len(test.waves))

    secs: Dict[str, float] = {}
    timer = Timer()

    def timed(name, compute):
        timer.reset()
        value = compute()
        secs[name] = timer.elapsed()
        logger.info("%s in %.1fs", name, secs[name])
        return value

    def _bootstrap():
        # the whole training set, so that every rank gets the one tree
        return bootstrap(compute_features(train, seed=seed, device=dev_),
                         train.transcripts, Lang.create(lex))

    am1, ali1, tri = timed("gmm_bootstrap", lambda: broadcast_object(
        sr.stage("gmm_bootstrap", _bootstrap) if rank == 0 else None))

    vol_tr, vol_dev, vol_te = timed("fbank", lambda: (
        compute_fbank_volumes(train_local, NUM_BINS, seed, dev_),
        compute_fbank_volumes(dev, NUM_BINS, seed + 1, dev_),
        compute_fbank_volumes(test, NUM_BINS, seed + 2, dev_)))
    tid2pdf = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    # streaming sharded egs (the scalable path): held-out utterances
    # form the in-memory validation set, everything else streams from
    # this rank's disk shards during training
    tmp_root = None
    if egs_dir is None and exp_dir:
        egs_dir = os.path.join(exp_dir, "egs")
    elif egs_dir is None:
        egs_dir = tmp_root = tempfile.mkdtemp(prefix="kct_egs_")
    rank_dir = os.path.join(egs_dir, f"rank{rank}")
    try:
        usable = sorted(u for u in vol_tr if u in ali1
                        and len(ali1[u]) == vol_tr[u].shape[0])
        n_valid_utts = max(len(usable) // 20, 2)
        valid_utts = set(usable[:n_valid_utts])
        store = timed("egs_store", lambda: sr.stage(
            "egs_store", lambda: write_cnn_egs_sharded(
                rank_dir, {u: vol_tr[u] for u in usable
                           if u not in valid_utts},
                ali1, tid2pdf, LEFT, RIGHT, num_shards=8, seed=seed)))
        egs_valid = make_cnn_egs({u: vol_tr[u] for u in valid_utts}, ali1,
                                 tid2pdf, LEFT, RIGHT, seed)
        logger.info("egs: %d train (streamed from %d shards in %s) / "
                    "%d valid", len(store), store.num_shards, rank_dir,
                    len(egs_valid))

        cfg = ConvnetConfig(
            in_t=LEFT + 1 + RIGHT, in_f=NUM_BINS, in_c=3,
            filt_t=4, filt_f=7, num_filters=num_filters,
            pool_t=2, pool_f=3, pool_c=1,
            num_hidden_layers=2, pnorm_input_dim=800, pnorm_output_dim=160,
            num_pdfs=num_pdfs)
        net = make_convnet(cfg, fused=True, device=dev_)
        tcfg = TrainConfig(num_epochs=nnet_epochs, minibatch_size=256,
                           initial_learning_rate=0.08,
                           final_learning_rate=0.008, seed=seed)
        if tcfg.minibatch_size % world:
            raise ValueError(f"minibatch {tcfg.minibatch_size} does not "
                             f"split over {world} ranks")
        # each rank streams its rows of every global minibatch
        batcher = StreamingEgsBatcher(store, tcfg.minibatch_size // world,
                                      seed)
        timed("nnet_train", lambda: train_multihost(
            net, None, egs_valid, tcfg, mh, mesh=mesh, metrics=metrics,
            batcher=batcher, local_batches=True))
        # pdf priors from the label counts across every rank's shards
        counts = np.zeros(num_pdfs, np.int64)
        for i in range(store.num_shards):
            _, ys, _ = store.load_shard(i)
            counts += np.bincount(ys, minlength=num_pdfs)
    finally:
        if tmp_root:
            shutil.rmtree(tmp_root, ignore_errors=True)
    counts = all_reduce(torch.as_tensor(counts, device=dev_),
                        mesh.world_group).cpu().numpy()
    frames = nnet_epochs * int(counts.sum())
    train_audio_ss = frames / 100.0 / max(secs["nnet_train"], 1e-9)
    logger.info("CNN trained in %.1fs over %d ranks (%.0f audio-s/s)",
                secs["nnet_train"], world, train_audio_ss)
    am_nnet = AmNnet(net, num_pdfs)
    am_nnet.set_priors_from_counts(counts)

    hclg = CompiledGraph(make_hclg_from_arpa(tri, make_unigram_arpa(wp)),
                         tid2pdf)

    dev_wer, pt, _ = timed("decode_dev", lambda: score_sweep(
        nnet_decode(am_nnet, vol_dev, hclg, mesh.world_group),
        dev.transcripts, tri.word_table))
    logger.info("dev WER %.2f%% at %s", dev_wer, pt)
    hyps = {}
    for utt, lat in timed("decode_test", lambda: nnet_decode(
            am_nnet, vol_te, hclg, mesh.world_group)).items():
        _, wids, _ = shortest_path(lat, 1.0, pt[0], pt[1])
        hyps[utt] = [tri.word_table.sym(int(w)) for w in wids]
    result = wer_details(test.transcripts, hyps)
    result.update(dev_wer=dev_wer, point=pt, train_audio_ss=train_audio_ss,
                  num_devices=world, backend=dist.get_backend(),
                  tree_leaves=num_pdfs, graph_states=hclg.num_states,
                  seconds=secs)
    logger.info("librispeech-style test WER %.2f%% (%d err / %d words)",
                result["wer"], result["errors"], result["words"])
    if metrics:
        metrics.write("librispeech_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


def main(argv=None) -> int:
    import argparse
    from kaldi_cnn_tpu_torch.core.stages import auto_stage
    ap = argparse.ArgumentParser(
        description="The Librispeech-style data-parallel CNN recipe as one "
                    "rank; rank 0 prints the result's numbers as one JSON "
                    "line.  Exits 1 unless test WER < 15 %, as the JAX "
                    "__main__.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-utts", type=int, default=0,
                    help="dedicated eval corpus size (ledger runs: 800)")
    ap.add_argument("--seed", type=int, default=53,
                    help="the corpus, dither, init and shuffle seed (the "
                         "bar is judged at the recipe's 53)")
    ap.add_argument("--exp-dir", default=None,
                    help="experiment dir for rank 0's stage artifacts "
                         "(enables --stage resume)")
    ap.add_argument("--stage", default="0",
                    help="resume from this stage index; 'auto' resumes "
                         "after the last completed stage")
    ap.add_argument("--coordinator", default="",
                    help="host:port of process 0 (several processes)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-replicas", type=int, default=1)
    ap.add_argument("--average-every", type=int, default=0,
                    help="steps between replica averages (> 0 with "
                         "several replicas)")
    a = ap.parse_args(argv)
    stage = 0
    if a.exp_dir:
        stage = (auto_stage(a.exp_dir) if a.stage == "auto"
                 else int(a.stage))
    mh = MultihostConfig(coordinator=a.coordinator,
                         num_processes=a.num_processes,
                         process_id=a.process_id,
                         num_replicas=a.num_replicas,
                         average_every=a.average_every)
    res = run(seed=a.seed, mh=mh, device=a.device, exp_dir=a.exp_dir,
              stage=stage, eval_utts=a.eval_utts)
    if a.process_id == 0:
        print(json.dumps({k: v for k, v in res.items() if k != "per_utt"}))
    return 0 if res["wer"] < 15.0 else 1


if __name__ == "__main__":
    sys.exit(main())
