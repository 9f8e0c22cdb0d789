"""Token-generation serving: prefill / decode step factories + ServeSession.

The port of ``repro/serve/session.py``: batched greedy generation over the
prefill and decode steps of a ``repro_torch.models`` Model. There is no
``jit``: the steps run eagerly, each attention layer on the port's kernels.
The VTA-side serving engine lives in serve/engine.py; both are exported
there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import tree_map
from repro_torch.utils.tree import tree_leaves
from repro_torch.models.registry import Model


def make_prefill_step(model: Model):
    """(params, batch) -> (last-position logits, caches). The head runs on
    the last position only: the step keeps only that row, as the
    reference's does."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, last_only=True)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, batch, caches, pos):
        logits, new_caches = model.decode(params, batch, caches, pos)
        return logits, new_caches
    return decode_step


def greedy_token(logits):
    """The first index of the largest logit, as int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class ServeSession:
    """Minimal batched generation loop over the eager steps.

    ``device`` defaults to ``"cuda"``, and raises where there is no CUDA
    device: the session never falls back to the CPU on its own;
    ``device="cpu"`` is explicit. The session keeps ``params`` on its
    device, cast once for the layers (``Model.cast_params``). As in the
    reference, the caches are the prompt's length and ``max_context`` is
    not read; each decode step writes its slot in place."""
    model: Model
    params: object
    max_context: int = 256
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = torch.device("cuda" if self.device is None
                                   else self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeSession: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.params = self.model.cast_params(
            tree_map(lambda t: t.to(self.device), self.params))
        self._prefill = make_prefill_step(self.model)
        self._decode = make_decode_step(self.model)

    def generate(self, tokens, n_steps: int):
        """tokens: (B, S) prompt (or (B,K,S) for codebook models), a tensor
        or an array. Returns (B, n_steps) (or (B, K*n_steps)) int32 tokens
        on the session's device. Runs under ``torch.inference_mode``, or
        ``torch.no_grad`` where the params are DTensors (under logical
        rules), which inference mode does not take (a view of a DTensor
        made in it cannot keep a version counter)."""
        dtensors = any(isinstance(t, DTensor)
                       for t in tree_leaves(self.params))
        with torch.no_grad() if dtensors else torch.inference_mode():
            return self._generate(tokens, n_steps)

    def _generate(self, tokens, n_steps: int):
        cfg = self.model.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, caches = self._prefill(self.params, {"tokens": tokens})
        S = tokens.shape[-1]
        out = []
        cur = greedy_token(logits)
        for step in range(n_steps):
            if cfg.n_codebooks:
                cur = cur.reshape(cur.shape[0], cfg.n_codebooks, 1)
            elif cur.dim() == 2:
                cur = cur[:, -1:]
            out.append(cur)
            logits, caches = self._decode(self.params, {"tokens": cur},
                                          caches, S + step)
            cur = greedy_token(logits)
        return torch.cat([o.reshape(o.shape[0], -1) for o in out], dim=-1)

