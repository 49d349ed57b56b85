"""Quickstart: train a tiny block-diffusion LM, then decode with Optimus
streaming chunked decoding and compare token utilization across chunk sizes.
The ``repro_torch`` twin of ``examples/quickstart.py``: the same model,
data, optimizer and printed lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--torch-device cpu]

The model trains and decodes on ``--torch-device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions).  The decode's prefill runs the
block-diffusion kernel and every window reads the slot cache through the
chunked-paged-attention kernel.  The diffusion masks of step ``i`` come
from ``step_generator(1, i, device)`` (the reference folds ``i`` into
``PRNGKey(1)``), so the losses are the reference's up to those draws.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.chunked import ChunkedDecodeState
from repro_torch.core.diffusion import softmax_confidence
from repro_torch.models import ArchConfig, build_model
from repro_torch.training import (AdamW, AdamWConfig, DataConfig,
                                  SyntheticTokenStream, make_train_step)
from repro_torch.training.train_loop import step_generator

CFG = ArchConfig(name="quickstart", family="dense", n_layers=2, d_model=128,
                 n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
                 block_size=8, confidence_threshold=0.6)
DATA = DataConfig(vocab_size=512, seq_len=64, global_batch=16)
STEPS = 60
CHUNKS = (2, 4, 8)
PROMPT_LEN, NEW_TOKENS, CACHE_LEN = 16, 32, 128


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to train and decode on (cpu runs the "
                         "plain versions)")
    return ap.parse_args(argv)


def torch_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device with no card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --torch-device cpu to run "
                           "on the CPU")
    return dev


def train(model, params, data, steps=STEPS, masks_for=None) -> list:
    """Train ``params`` in place on the synthetic Markov data (diffusion
    objective) with AdamW; step ``i``'s masks are ``masks_for(i)`` when
    given, else drawn from ``step_generator(1, i, device)``.  Prints the
    loss every 20 steps; returns every step's loss."""
    dev = next(iter(params.values())).device
    opt = AdamW(AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    step = make_train_step(model, opt)
    state = opt.init(params)
    losses = []
    for i in range(steps):
        batch = {"tokens": torch.as_tensor(data.batch(i), device=dev)}
        masks = None if masks_for is None else masks_for(i)
        params, state, m = step(params, state, batch,
                                gen=step_generator(1, i, dev), masks=masks)
        losses.append(m["loss"])
        if (i + 1) % 20 == 0:
            print(f"train step {i+1}: loss {float(m['loss']):.3f}")
    return [float(x) for x in losses]


def decode(model, params, prompt, chunk: int, steps: list | None = None):
    """Streaming chunked decode of ``NEW_TOKENS`` after ``prompt`` on the
    dense-slot cache: prefill, then windows of ``chunk`` until done, each
    window's logits sampled on the host.  With ``steps``, each window
    appends what decided its commits (the window, confidences, tokens, the
    commit mask, and the logits' top-1 and top-1/top-2 gap).  Returns the
    decode state."""
    cfg = model.cfg
    dev = next(iter(params.values())).device
    cache = model.init_cache(1, CACHE_LEN, dtype=torch.float32, device=dev)
    model.prefill(params, torch.as_tensor(prompt[None], device=dev),
                  torch.tensor([len(prompt)], dtype=torch.int32, device=dev),
                  cache)
    st = ChunkedDecodeState(prompt_len=len(prompt),
                            max_new_tokens=NEW_TOKENS,
                            block_size=cfg.block_size,
                            threshold=cfg.confidence_threshold,
                            mask_token=cfg.mask_token_id)
    while not st.done:
        toks, start, valid, cai = st.window(chunk)
        logits, win_kv = model.chunk_forward(
            params, cache, torch.as_tensor(toks[None], device=dev),
            torch.tensor([start], device=dev),
            torch.tensor([valid], device=dev))
        host = logits[0].cpu().numpy()
        conf, tok = softmax_confidence(host)
        frozen = st.frozen
        commit, n_adv = st.apply_step(conf, tok, valid, cai)
        if steps is not None:
            top2 = -np.sort(-host[:valid], axis=-1)[:, :2].astype(np.float64)
            steps.append({"frozen": frozen, "valid": valid, "c": chunk,
                          "threshold": float(st.threshold),
                          "cai": np.array(cai[:valid]),
                          "commit": np.array(commit[:valid]),
                          "tok": tok[:valid], "conf": conf[:valid],
                          "top1": top2[:, 0], "gap": top2[:, 0] - top2[:, 1]})
        model.freeze(cache, win_kv, torch.tensor([start], device=dev),
                     torch.tensor([n_adv], device=dev))
        st.advance(n_adv)
    return st


def main(argv=None, params=None, masks_for=None) -> dict:
    """Train, then decode at each chunk size; ``params`` (a flat param
    dict, any device) starts from those weights instead of the seeded
    ones.  Returns the losses, each chunk's decode numbers and tokens, and
    the agreements."""
    args = parse_args(argv)
    dev = torch_device(args.torch_device)
    model = build_model(CFG)
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
    params = {k: v.to(dev, copy=True) for k, v in params.items()}

    # --- 1. train briefly on synthetic Markov data (diffusion objective) --
    data = SyntheticTokenStream(DATA)
    losses = train(model, params, data, masks_for=masks_for)

    # --- 2. decode with streaming chunked decoding ------------------------
    prompt = np.asarray(data.batch(999)[0, :PROMPT_LEN], np.int64)
    print("\nchunk | steps | computed | TU")
    outs, table = {}, {}
    for chunk in CHUNKS:
        st = decode(model, params, prompt, chunk)
        outs[chunk] = st.output_tokens
        table[chunk] = {"steps": st.steps,
                        "computed_tokens": st.computed_tokens,
                        "tu": st.token_utilization}
        print(f"{chunk:5d} | {st.steps:5d} | {st.computed_tokens:8d} "
              f"| {st.token_utilization:.3f}")

    # With a real model, confidences depend on how much suffix the window
    # makes visible, so different chunk sizes may commit slightly different
    # tokens — the paper's finding that chunked decoding preserves accuracy
    # approximately (§7.2), while the *scheduling machinery* is exactly
    # order-preserving (tests/test_chunked_equivalence.py).
    ref = outs[8]
    agree = {}
    for c in (2, 4):
        agree[c] = float(np.mean([a == b for a, b in zip(outs[c], ref)]))
        print(f"token agreement chunk {c} vs 8: {agree[c]:.0%}")
    print("tokens:", ref[:16], "...")
    return {"losses": losses, "decode": table, "outputs": outs,
            "agreement": agree, "params": params, "prompt": prompt}


if __name__ == "__main__":
    main()
