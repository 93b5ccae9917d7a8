#!/usr/bin/env python3
"""Probes of the fault-tolerant ``fit`` on one NVIDIA GPU.

    python3 ft_probe.py

1. The asynchronous checkpoint's cost to training: BERT-Base (the smoke's
   BERTClassifier, bf16 compute, batch 32, L = 128) trains one epoch with
   no write in flight, then ``save_async`` of its 1.31 GB snapshot and two
   epochs while the write runs, for three ways of writing (in turns,
   twice each): the port's (copies into pinned host buffers on the
   stream, written from the arrays' own buffers), ``device_clone`` (a
   device clone, copied to pageable host memory on the writer thread),
   and ``copying_writer`` (the pinned copies, written by ``np.savez`` with
   CRCs over ``tobytes`` copies, both of which hold the GIL as they copy).
   Prints ms per step quiet and in flight, the seconds ``save_async``
   takes to return and the write's total.
2. Gradient accumulation against the full batch: NeuralCF at the ML-1M
   width on ``generate_movielens_like(seed=0)`` in the order one shuffle
   draws, SGD, ``grad_accum_steps=2`` at batch 1024 against batch 2048,
   the largest weight difference after 8, 16 and 58 steps at lr 0.5 and
   after 58 at lr 0.05 and 0.005, and the non-finite steps of each run.

Every line names the card and its power limit.  Exits non-zero without a
CUDA device.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np


def log(*a):
    print(*a, flush=True)


def writer_probe(torch, card):
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train import checkpoint as ck
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    init_zoo_context()
    ids, seg, y = cs.bert_train_data(256, 128, cs.SEED + 4)
    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=dict(
        cs.BERT_BASE, attn_drop=0.0, hidden_drop=0.1),
        generator=torch.Generator().manual_seed(cs.SEED))
    net.compile(AdamWeightDecay(5e-5, warmup_portion=0.1, total=1000),
                "sparse_categorical_crossentropy_with_logits",
                device="cuda", compute_dtype="bfloat16")
    net.fit([ids, seg], y, batch_size=32, epochs=1, verbose=False)
    est = net.estimator

    def ms_per_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit([ids, seg], y, batch_size=32,
                epochs=est.finished_epochs + 1, verbose=False)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 8

    pinned_copy = ck.CheckpointManager._copy_off
    own_write, own_crc = ck._write_npz, ck._crc32

    def device_clone(self, tree, path, cuda):
        if isinstance(tree, torch.Tensor) and tree.is_cuda:
            cuda.append(path)
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: device_clone(self, v, f"{path}/{k}", cuda)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [device_clone(self, v, f"{path}/{n}", cuda)
                    for n, v in enumerate(tree)]
        return pinned_copy(self, tree, path, cuda)

    def savez(f, arrays):
        np.savez(f, **arrays)

    def tobytes_crc(a):
        return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF

    ways = {"port": (pinned_copy, own_write, own_crc),
            "device_clone": (device_clone, own_write, own_crc),
            "copying_writer": (pinned_copy, savez, tobytes_crc)}
    root = tempfile.mkdtemp(prefix="zoo_probe_")
    try:
        for name in list(ways) * 2:
            (ck.CheckpointManager._copy_off, ck._write_npz,
             ck._crc32) = ways[name]
            mgr = ck.CheckpointManager(os.path.join(root, name), keep=1)
            mgr.save_async(est.global_step, est._snapshot())  # warm buffers
            mgr.wait()
            quiet = ms_per_step()
            t0 = time.perf_counter()
            mgr.save_async(est.global_step, est._snapshot())
            returned = time.perf_counter() - t0
            busy = [ms_per_step(), ms_per_step()]
            mgr.wait()
            log("async_writer", card, json.dumps({
                "way": name, "ms_per_step_quiet": quiet,
                "ms_per_step_in_flight": busy, "return_s": returned,
                "write_total_s": time.perf_counter() - t0}))
            shutil.rmtree(os.path.join(root, name))
    finally:
        (ck.CheckpointManager._copy_off, ck._write_npz,
         ck._crc32) = ways["port"]
        shutil.rmtree(root, ignore_errors=True)


def accumulation_probe(torch, card):
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.core.profiling import TIMERS
    from analytics_zoo_tpu_torch.data import generate_movielens_like
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.optimizers import SGD

    init_zoo_context()
    users, items, ratings = generate_movielens_like(seed=cs.SEED)
    order = np.random.RandomState(42).permutation(len(users))
    u = users[order][:, None].astype(np.int32)
    i = items[order][:, None].astype(np.int32)
    y = (ratings[order] - 1).astype(np.int32)
    reset_name_scope()
    init = export_params(NeuralCF(cs.USERS, cs.ITEMS, device="cuda").model)

    def run(batch, accum, steps, lr):
        reset_name_scope()
        ncf = NeuralCF(cs.USERS, cs.ITEMS, device="cuda")
        load_jax_params(ncf.model, init)
        ncf.compile(SGD(lr=lr), "sparse_categorical_crossentropy",
                    grad_accum_steps=accum)
        n = steps * cs.TRAIN_BATCH
        bad = TIMERS.count("robust/nan_steps")
        ncf.fit([u[:n], i[:n]], y[:n], batch_size=batch, epochs=1,
                shuffle=False, verbose=False)
        return (export_params(ncf.model),
                TIMERS.count("robust/nan_steps") - bad)

    full_steps = len(y) // cs.TRAIN_BATCH
    for lr, steps in ((0.5, 8), (0.5, 16), (0.5, full_steps),
                      (0.05, full_steps), (0.005, full_steps)):
        half, bad_half = run(cs.TRAIN_BATCH // 2, 2, steps, lr)
        full, bad_full = run(cs.TRAIN_BATCH, 1, steps, lr)
        log("accumulation", card, json.dumps({
            "lr": lr, "updates": steps,
            "weights_max_abs_diff": cs.tree_diff(half, full)[0],
            "weights_max_abs_moved": cs.tree_diff(full, init)[0],
            "non_finite_steps": [bad_half, bad_full]}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ft_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    writer_probe(torch, card)
    accumulation_probe(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
