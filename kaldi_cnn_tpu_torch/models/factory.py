"""Standard acoustic-model architectures (twin of
``kaldi_cnn_tpu/models/factory.py``): the fork's CNN AM, the CNN with a
speaker iVector beside its conv front end, and the p-norm DNN they are
compared with."""

from __future__ import annotations

from typing import Optional

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.models.components import (
    AffineComponent, Conv2DComponent, IdentityComponent,
    Maxpooling3DComponent, NormalizeComponent, PnormComponent,
    SliceParallelComponent, SoftmaxComponent)
from kaldi_cnn_tpu_torch.models.nnet import Nnet


@configclass
class ConvnetConfig:
    """The fork's headline CNN AM over spliced fbank patches."""

    in_t: int = 11           # splice ±5 frames of fbank
    in_f: int = 36           # mel bins
    in_c: int = 3            # static + delta + delta-delta channels
    filt_t: int = 4
    filt_f: int = 7
    num_filters: int = 128
    pool_t: int = 2
    pool_f: int = 3
    pool_c: int = 1
    num_hidden_layers: int = 2
    pnorm_input_dim: int = 2000
    pnorm_output_dim: int = 400
    num_pdfs: int = 2000

    @property
    def input_dim(self) -> int:
        return self.in_t * self.in_f * self.in_c


def _conv_pool(cfg: ConvnetConfig, fused: bool, device):
    conv = Conv2DComponent(cfg.in_t, cfg.in_f, cfg.in_c, cfg.filt_t,
                           cfg.filt_f, cfg.num_filters, fused=fused,
                           device=device)
    pool = Maxpooling3DComponent(conv.out_t, conv.out_f, cfg.num_filters,
                                 cfg.pool_t, cfg.pool_f, cfg.pool_c)
    return conv, pool


def _pnorm_stack(comps, dim: int, cfg, device) -> Nnet:
    """comps + hidden x (Affine -> Pnorm -> Normalize) -> Affine ->
    Softmax, from ``dim`` inputs."""
    for _ in range(cfg.num_hidden_layers):
        comps += [
            AffineComponent(dim, cfg.pnorm_input_dim, device=device),
            PnormComponent(cfg.pnorm_input_dim, cfg.pnorm_output_dim),
            NormalizeComponent(cfg.pnorm_output_dim),
        ]
        dim = cfg.pnorm_output_dim
    comps += [
        AffineComponent(dim, cfg.num_pdfs, param_stddev=0.0, device=device),
        SoftmaxComponent(cfg.num_pdfs),
    ]
    return Nnet(comps)


def make_convnet(cfg: Optional[ConvnetConfig] = None, fused: bool = True,
                 device="cuda") -> Nnet:
    """Conv2D -> Maxpool3D -> hidden x (Affine -> Pnorm -> Normalize) ->
    Affine -> Softmax, with zero parameters (``Nnet.init`` draws them).
    ``fused`` opts the conv+pool pair into Nnet.predict's fused kernel."""
    cfg = cfg or ConvnetConfig()
    conv, pool = _conv_pool(cfg, fused, device)
    return _pnorm_stack([conv, pool], pool.output_dim, cfg, device)


def make_convnet_ivector(cfg: Optional[ConvnetConfig] = None,
                         ivector_dim: int = 16, fused: bool = True,
                         device="cuda") -> Nnet:
    """The CNN with an appended speaker iVector that bypasses the conv
    front end (the Switchboard CNN + online-iVector configuration): rows
    are [volume | iVector], SliceParallel(Conv2D, Identity) ->
    SliceParallel(Maxpool3D, Identity) -> the p-norm stack, with zero
    parameters.  ``fused`` opts the pair of slices into Nnet.predict's
    fused conv+maxpool kernel."""
    cfg = cfg or ConvnetConfig()
    conv, pool = _conv_pool(cfg, fused, device)
    front = SliceParallelComponent([conv, IdentityComponent(ivector_dim)])
    mid = SliceParallelComponent([pool, IdentityComponent(ivector_dim)])
    return _pnorm_stack([front, mid], pool.output_dim + ivector_dim, cfg,
                        device)


@configclass
class PnormDnnConfig:
    """p-norm DNN on (typically fMLLR) features
    (ref: steps/nnet2/train_pnorm_simple.sh, the RM config)."""

    input_dim: int = 360     # 40-d fMLLR spliced ±4
    num_hidden_layers: int = 3
    pnorm_input_dim: int = 1000
    pnorm_output_dim: int = 200
    num_pdfs: int = 1500


def make_pnorm_dnn(cfg: Optional[PnormDnnConfig] = None,
                   device="cuda") -> Nnet:
    """hidden x (Affine -> Pnorm -> Normalize) -> Affine -> Softmax, with
    zero parameters (``Nnet.init`` draws them)."""
    cfg = cfg or PnormDnnConfig()
    return _pnorm_stack([], cfg.input_dim, cfg, device)
