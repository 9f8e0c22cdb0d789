"""Trainer: wires model, data, optimizer, checkpointing and fault
tolerance; the port of ``repro/train/loop.py``.

The step runs eagerly (the reference jits it): ``make_train_step``'s
function, every attention layer on the port's kernels. It is built with
``donate=True``, as the reference donates params and optimizer state
(``donate_argnums=(0, 1)``): each step writes the new state over the old,
so one train state is held, not two. ``CheckpointManager.save`` takes its
host copy before it returns, so an async save keeps the step it was given
though the next step overwrites the tensors. The Trainer runs on
``device``, ``"cuda"`` by default, and raises where there is no CUDA
device: it never falls back to the CPU on its own; ``device="cpu"`` is
explicit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, DataLoader
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               StragglerDetector)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step


@dataclass
class TrainerConfig:
    num_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    async_ckpt: bool = True
    seed: int = 0
    heartbeat_dir: Optional[str] = None
    host: str = "host0"


class Trainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 opt_cfg: AdamWConfig, tcfg: TrainerConfig, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.model = build_model(model_cfg)
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.step_fn = make_train_step(self.model, opt_cfg, donate=True)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep_last_k=tcfg.keep_ckpts,
                                       async_save=tcfg.async_ckpt)
                     if tcfg.ckpt_dir else None)
        self.hb = (HeartbeatMonitor(tcfg.heartbeat_dir, tcfg.host)
                   if tcfg.heartbeat_dir else None)
        self.straggler = StragglerDetector()
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def init_params(self):
        """The params a run starts from, drawn from ``tcfg.seed`` on the
        Trainer's device: those of step 1 where no checkpoint resumes."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return self.model.init(gen, self.device)

    def init_or_resume(self):
        params = self.init_params()
        opt_state = init_opt_state(params)
        start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            (params, opt_state), start_step = self.ckpt.restore(
                (params, opt_state), device=self.device)
        return params, opt_state, start_step

    def run(self, num_steps: Optional[int] = None):
        num_steps = num_steps or self.tcfg.num_steps
        params, opt_state, start = self.init_or_resume()
        loader = DataLoader(self.data_cfg, self.model_cfg, start_step=start)
        step = start
        try:
            while step < num_steps:
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in next(loader).items()}
                t0 = time.time()
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])          # blocks; ok for the loop
                dt = time.time() - t0
                step += 1
                slow = self.straggler.record(step, dt)
                if self.hb is not None:
                    self.hb.beat(step)
                rec = {"step": step, "loss": loss, "time_s": dt,
                       "straggler": slow,
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"])}
                self.history.append(rec)
                if step % self.tcfg.log_every == 0 or step == num_steps:
                    print(f"step {step:5d}  loss {loss:8.4f}  "
                          f"gnorm {rec['grad_norm']:8.3f}  {dt*1e3:7.1f} ms"
                          + ("  [straggler]" if slow else ""))
                if self.ckpt is not None and step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step, (params, opt_state))
            if self.ckpt is not None:
                self.ckpt.save(step, (params, opt_state))
                self.ckpt.wait()
        finally:
            loader.close()
        return params, opt_state, self.history
