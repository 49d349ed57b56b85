"""Training loop: the train step (with microbatched gradient accumulation),
periodic asynchronous checkpoints, restart from the latest one, failure
injection and straggler monitoring (the JAX package's
``training/train_loop.py``).

The step differentiates the models' training route with ``torch.autograd``
(the hand kernels have no backward pass and are never on it), then runs
:meth:`AdamW.update`, which writes the params and moments in place.  On a
CUDA device :class:`Trainer` replays the whole step — every microbatch's
forward and backward, and the update — as one CUDA graph
(``serving/graphs.py``), the torch form of the reference's
``jax.jit(make_train_step(...))``.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.models.registry import build_model
from repro_torch.serving.graphs import DispatchGraphs
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import DataConfig, SyntheticTokenStream
from repro_torch.training.fault_tolerance import StragglerMonitor
from repro_torch.training.objectives import (block_diffusion_terms,
                                             diffusion_masks, encdec_terms,
                                             mean_of, terms_for)
from repro_torch.training.optimizer import AdamW, AdamWConfig


def _split(x, n: int):
    """[n·b, …] → n microbatches of [b, …] (the reference's reshape)."""
    if x is None:
        return [None] * n
    if isinstance(x, dict):
        parts = {k: _split(v, n) for k, v in x.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not {n} whole microbatches")
    return list(x.reshape((n, -1) + tuple(x.shape[1:])).unbind(0))


def make_train_step(model, optimizer, *, microbatches: int = 1):
    """Build the train step ``step(params, opt_state, batch, gen=None,
    masks=None) -> (params, opt_state, metrics)``.

    batch: {"tokens": [B, T]} (+ "lengths", "mm_embeds", "mm_mask"), or
    the encoder–decoder's {"src_embeds", "src_mask", "tgt_tokens"}.  A
    diffusion objective draws its masks for the whole batch from ``gen``
    (a ``torch.Generator``) unless ``masks`` gives them.  With
    ``microbatches > 1`` the batch and its masks are split, each part's
    (Σ nll·w, Σ w) gradients accumulated in fp32, and the sum divided by
    the whole batch's Σ w: the full-batch loss and gradient, up to the
    order of the sums (the reference averages the parts' losses instead,
    which is the same when every part's Σ w is, as for the AR loss without
    lengths).  ``params`` and ``opt_state`` are updated in place.
    """
    cfg = model.cfg
    terms_fn = terms_for(cfg)
    encdec = cfg.family == "encdec"
    diffusion = terms_fn is block_diffusion_terms or (
        terms_fn is encdec_terms and cfg.diffusion)

    def compute_terms(params, batch, masks):
        if encdec:
            return terms_fn(model, params, batch, masks=masks)
        extras = {k: batch[k] for k in ("mm_embeds", "mm_mask")
                  if k in batch}
        return terms_fn(model, params, batch["tokens"],
                        lengths=batch.get("lengths"), masks=masks, **extras)

    def grads_of(out, leaves):
        gs = torch.autograd.grad(out, list(leaves.values()),
                                 allow_unused=True)
        return {k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(leaves.items(), gs)}

    def step(params, opt_state, batch, gen=None, masks=None):
        if diffusion and masks is None:
            B, T = batch["tgt_tokens" if encdec else "tokens"].shape
            masks = diffusion_masks(gen, B, T, cfg.block_size)
        # detached aliases: autograd leaves that share the params' storage
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in params.items()}
        if microbatches == 1:
            with torch.enable_grad():
                loss = mean_of(*compute_terms(leaves, batch, masks))
                grads = grads_of(loss, leaves)
            loss = loss.detach()
        else:
            acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in params.items()}
            num = den = 0.0
            for mb, mk in zip(_split(batch, microbatches),
                              _split(masks, microbatches)):
                with torch.enable_grad():
                    n_i, d_i = compute_terms(leaves, mb, mk)
                    g = grads_of(n_i, leaves)
                for k, a in acc.items():
                    a += g[k].float()
                num, den = num + n_i.detach(), den + d_i.detach()
            den = torch.clamp(den, min=1.0)
            grads = {k: a / den for k, a in acc.items()}
            loss = num / den
        params, opt_state, metrics = optimizer.update(grads, opt_state,
                                                      params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The diffusion masks' generator of training step ``step``: a pure
    function of (seed, step), so a resumed run draws the masks of an
    uninterrupted one."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50               # 0: no checkpoints
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0


def _state_ptrs(state) -> tuple:
    """The ``data_ptr``\\ s of a train state's params and optimizer leaves
    (what a captured step writes in place)."""
    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        else:
            yield x
    return tuple(t.data_ptr() for t in leaves(
        {"params": state["params"], "opt": state["opt"]}))


class Trainer:
    """Single-process trainer with checkpoint/restart, on ``device``.

    ``graphs`` as ``ModelBackend`` takes it: ``None`` replays the train
    step as one CUDA graph on a CUDA device (captured at a key's first
    step, which runs eagerly and is the step) and runs it eagerly
    elsewhere; ``False`` is the eager twin; a capturer object (e.g.
    ``graphs.RerunCapturer()`` on the CPU) stands in for the card's.  The
    graph's key is ``("train", B, T, microbatches, family)``; its static
    inputs are the tokens and the diffusion masks, which are drawn outside
    the graph from :func:`step_generator`, as the eager step draws them.
    The params and moments are the live tensors: a replay that finds one
    moved raises.  Each :meth:`start` makes a new graph cache for its
    state (after any restore)."""

    def __init__(self, arch_cfg, data_cfg: DataConfig,
                 opt_cfg: AdamWConfig | None = None,
                 trainer_cfg: TrainerConfig | None = None,
                 failure_injector=None, *, device="cuda", graphs=None):
        self.arch_cfg = arch_cfg
        self.model = build_model(arch_cfg)
        self.opt = AdamW(opt_cfg or AdamWConfig())
        self.tc = trainer_cfg or TrainerConfig()
        self.data = SyntheticTokenStream(data_cfg)
        self.ckpt = ckpt_lib.CheckpointManager(self.tc.ckpt_dir)
        self.monitor = StragglerMonitor()
        self.failure_injector = failure_injector
        self.device = torch.device(device)
        self._step_fn = make_train_step(self.model, self.opt,
                                        microbatches=self.tc.microbatches)
        self._diffusion = terms_for(self.model.cfg) is block_diffusion_terms
        self._graphs = graphs
        self.graphs = None          # the graph cache of the last start()

    def init_state(self):
        """Weights drawn from a generator seeded with ``TrainerConfig.seed``
        (so every process draws the same ones), fresh AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = self.model.init_params(gen, device=self.device)
        return {"params": params, "opt": self.opt.init(params), "step": 0}

    def start(self, resume: bool = True):
        """``(state, first step)``: a fresh state, or with ``resume`` the
        latest checkpoint's; then a new graph cache for that state (the
        last one, which holds its own state, is let go first)."""
        self.graphs = None
        state = self.init_state()
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            restored, start = self.ckpt.restore_latest(
                {"params": state["params"], "opt": state["opt"]})
            state["params"], state["opt"] = restored["params"], restored["opt"]
        graphs = self._graphs
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.graphs = None if graphs is False else DispatchGraphs(
            self.device, lambda: _state_ptrs(state),
            capturer=None if graphs is True else graphs)
        return state, start

    def train_step(self, state, step: int) -> dict:
        """Train step ``step`` on ``state`` (params and moments updated in
        place): its batch, its masks from :func:`step_generator`, then the
        step eagerly or as a replay.  Returns the metrics, device scalars
        (a replay's are the graph's static outputs)."""
        tokens = self.data.batch(step)
        masks = None
        if self._diffusion:
            masks = diffusion_masks(
                step_generator(self.tc.seed, step, self.device),
                *tokens.shape, self.model.cfg.block_size)
        if self.graphs is None:
            _, _, metrics = self._step_fn(
                state["params"], state["opt"],
                {"tokens": torch.as_tensor(tokens, device=self.device)},
                masks=masks)
            return metrics

        def captured(t):
            mk = None if masks is None else {k: t[k] for k in masks}
            _, _, m = self._step_fn(state["params"], state["opt"],
                                    {"tokens": t["tokens"]}, masks=mk)
            return m["loss"], m["grad_norm"], m["lr"]

        key = ("train", *tokens.shape, self.tc.microbatches,
               self.model.cfg.family)
        loss, gnorm, lr = self.graphs.dispatch(
            key, captured, {"tokens": tokens, **(masks or {})})
        return {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def run(self, resume: bool = True):
        """Train to ``total_steps`` (from the latest checkpoint when
        ``resume``); returns this run's losses."""
        state, start = self.start(resume)
        losses = []
        try:
            for step in range(start, self.tc.total_steps):
                if self.failure_injector is not None:
                    self.failure_injector.check(step)
                t0 = time.perf_counter()
                metrics = self.train_step(state, step)
                loss = float(metrics["loss"])
                self.monitor.record(0, time.perf_counter() - t0)
                losses.append(loss)
                if self.tc.ckpt_every > 0 and (
                        (step + 1) % self.tc.ckpt_every == 0
                        or step + 1 == self.tc.total_steps):
                    # the save copies every leaf to the host before it
                    # returns: the next replay cannot race it
                    self.ckpt.save(step + 1, {"params": state["params"],
                                              "opt": state["opt"]})
                if (step + 1) % self.tc.log_every == 0:
                    print(f"step {step + 1}: loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.2f}",
                          flush=True)
        finally:
            # a failure propagates only once the save in flight is on disk
            self.ckpt.wait()
        return losses
