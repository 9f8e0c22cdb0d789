"""Model facade: config -> bound init/apply/serve functions.

The port of ``repro/models/registry.py``. ``build_model(cfg,
attention=...)`` picks what every attention layer calls, in ``forward``,
``prefill``, ``decode`` and ``loss`` alike: ``"cuda"`` (the default),
``repro_torch.kernels.ops.flash_attention``, whose CUDA tensors launch the
port's kernels or raise and whose CPU tensors take the plain version, with
the gradient of the op ``repro_torch::flash_attention`` on both;
``"torch"``, the plain version ``flash_attention_plain`` on either device
(autograd differentiates it), which only the tests and ``chip_smoke.py``'s
comparison use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import transformer as tfm

ATTENTION = {"cuda": flash_attention, "torch": flash_attention_plain}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable            # (generator, device) -> params
    specs: Callable           # () -> Spec tree
    logical_names: Callable   # () -> names tree
    forward: Callable         # (params, batch) -> (logits, aux, caches)
    loss: Callable            # (params, batch) -> (loss, metrics)
    prefill: Callable         # (params, batch, last_only=False) -> (logits, caches)
    decode: Callable          # (params, batch, caches, pos) -> (logits, caches)
    cache_specs: Callable     # (batch, seq) -> cache tree of TensorSpecs
    init_caches: Callable     # (batch, seq, device) -> zero cache tree
    cast_params: Callable     # (params) -> params cast once for the layers


def build_model(cfg: ModelConfig, *, attention: str = "cuda") -> Model:
    if attention not in ATTENTION:
        raise ValueError(f"attention {attention!r}: one of {sorted(ATTENTION)}")
    attend = ATTENTION[attention]

    def prefill(params, batch, last_only: bool = False):
        logits, _, caches = tfm.forward(params, batch, cfg, want_cache=True,
                                        last_only=last_only, attend=attend)
        return logits, caches

    return Model(
        cfg=cfg,
        init=lambda generator, device: tfm.init_params(cfg, generator,
                                                       device),
        specs=lambda: tfm.model_specs(cfg),
        logical_names=lambda: tfm.param_logical_names(cfg),
        forward=lambda params, batch: tfm.forward(params, batch, cfg,
                                                  attend=attend),
        loss=lambda params, batch: tfm.loss_fn(params, batch, cfg,
                                               attend=attend),
        prefill=prefill,
        decode=lambda params, batch, caches, pos: tfm.decode_step(
            params, batch, caches, pos, cfg, attend=attend),
        cache_specs=lambda batch, seq: tfm.cache_specs(cfg, batch, seq),
        init_caches=lambda batch, seq, device: tfm.init_caches(
            cfg, batch, seq, device),
        cast_params=lambda params: tfm.cast_params(params, cfg),
    )
