"""Training on a corpus resident on the card, as the trainer's device path
runs it (generator ``train_chunks``).

The mix's file gives the corpus in the chunk store's own layout (per chunk
its subjects and windows, padded to buckets of subjects and windows) and
the batch.  Set-up makes every chunk on the card from the seed and builds
the model, its weights and AdamW; a seeded walk copies the store's
sampling: the chunk order shuffled each epoch, per chunk and subject a batch
of windows drawn without replacement, the subjects permuted across each
column of the batches.  Every step is the program's
``chunk_train_step``, fed as the trainer feeds it (one pinned index upload
per chunk).

Set-up drives the first three steps, which the reference follows, then
``warmup_steps`` more; the window then steps until ``--seconds`` have
passed and ends in ``torch.cuda.synchronize()``.  In a traced run the
profiler covers two stretches of ``profile_steps`` steps each, from
``profile_at`` of the window in: the device alone, then the host and the
device, each between two synchronisations; the host-clock numbers are
taken from the rest of the window.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import checks, harness, spec, weights

CHECK_STEPS = 3


def bucket(n: int, step: int) -> int:
    return -(-n // step) * step


def make_corpus(traffic: dict, cfg, seed: int, device) -> list:
    """The chunks on the card: EEG ``[subjects, windows, T, 64]`` and speech
    ``[windows, T, F]`` N(0, 1) in their real rows and zero in the padding,
    and the windows' segment ids (1, 2, ... over the corpus; 0 in the
    padding)."""
    gen = torch.Generator(device=device).manual_seed(weights.stream_seed(seed, 1))
    t, n_win = cfg.window_length, traffic["windows_per_chunk"]
    pw = bucket(n_win, traffic["window_bucket"])
    chunks, first_id = [], 1
    for n_subs in traffic["subjects_per_chunk"]:
        ps = bucket(n_subs, traffic["subject_bucket"])
        eeg = torch.zeros((ps, pw, t, traffic["eeg_channels"]), device=device)
        speech = torch.zeros((pw, t, cfg.speech_dimension), device=device)
        eeg[:n_subs, :n_win].normal_(generator=gen)
        speech[:n_win].normal_(generator=gen)
        ids = torch.zeros(pw, dtype=torch.int64, device=device)
        ids[:n_win] = torch.arange(first_id, first_id + n_win, device=device)
        first_id += n_win
        chunks.append({"eeg": eeg, "speech": speech, "ids": ids, "subjects": n_subs})
    return chunks


def segments(traffic: dict) -> int:
    return traffic["windows_per_chunk"] * len(traffic["subjects_per_chunk"])


def walk(chunks: list, traffic: dict, batch: int, seed: int, device):
    """Batches for ever: ``(chunk, idx, subs)`` with the index vectors on the
    card (one upload a chunk, as the trainer's ``device_indices``) and on
    the host."""
    from transformer_clip_eeg_tpu_torch.train.loop import device_indices

    rng = np.random.default_rng(weights.stream_seed(seed, 2))
    n_win, share = traffic["windows_per_chunk"], traffic["shuffle_percentage"]
    while True:
        order = list(range(len(chunks)))
        rng.shuffle(order)
        for c in order:
            n_subs = chunks[c]["subjects"]
            idx = np.stack([rng.choice(n_win, batch, replace=False) for _ in range(n_subs)])
            subs = np.repeat(np.arange(n_subs), batch).reshape(n_subs, batch)
            cut = int(batch * share)
            subs = np.concatenate([rng.permuted(subs[:, :cut], axis=0), subs[:, cut:]], axis=1)
            idx_d, subs_d = device_indices(device, idx, subs)
            for i in range(n_subs):
                yield chunks[c], idx_d[i], subs_d[i], idx[i], subs[i]


def run(ctx) -> dict:
    from transformer_clip_eeg_tpu_torch.train.state import make_optimizer
    from transformer_clip_eeg_tpu_torch.train.steps import chunk_train_step

    tr, dev, seed = ctx.traffic, ctx.device, ctx.seed
    cfg = harness.train_config(ctx.config)
    bs = cfg.batch_size
    chunks = make_corpus(tr, cfg, seed, dev)
    model = harness.build_model(cfg, segments(tr), seed, dev)
    params0, state0 = weights.snapshot(model)
    opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
                         cfg.beta2, cfg.weight_decay, cfg.amsgrad_b)
    names = [k for k, _ in model.named_parameters()]
    feed = walk(chunks, tr, bs, seed, dev)
    step_kw = dict(model_arch=cfg.model_arch, augmentations=cfg.augmentations,
                   augmentation_probability=cfg.data_augmentation_percentage,
                   add_eeg=cfg.addEEG_b, compute_dtype=cfg.compute_dtype)

    def step(item):
        chunk, idx_d, subs_d, _, _ = item
        return chunk_train_step(model, opt, chunk["eeg"], chunk["speech"], chunk["ids"],
                                idx_d, subs_d, seed, False, **step_kw)

    # the checked steps: the window's own call and feed, the reference's inputs kept
    batches, prog_losses, first_grad = [], [], None
    for k in range(CHECK_STEPS):
        item = next(feed)
        batches.append(host_batch(item, dev))
        prog_losses.append({n: float(v) for n, v in step(item).items()})
        if k == 0:  # the gradient as the optimizer holds it: mu = (1 - b1) g
            flat = (opt.mu / (1 - opt.b1)).split([p.numel() for p in opt.params])
            first_grad = {n: g.view_as(p).cpu() for n, g, p in zip(names, flat, opt.params)}
    params3, state3 = weights.snapshot(model)
    for _ in range(tr["warmup_steps"]):
        step(next(feed))
    if ctx.traced:
        from portbench.trace import Profiled

        Profiled(dev, host=False).warm_up()
        Profiled(dev, host=True).warm_up()
    harness.synchronize(dev)

    spans, profs = ctx.spans, []
    steps, prof_steps, steps_before = 0, 0, 0
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    prof_at = t0 + tr["profile_at"] * ctx.seconds if ctx.traced else float("inf")
    while time.perf_counter() < end:
        if not profs and time.perf_counter() >= prof_at:
            # two stretches back to back: the device alone, then host and device
            for host in (False, True):
                harness.synchronize(dev)
                prof = Profiled(dev, host=host)
                prof.start()
                spans.profiling = ctx.kernels.recording = host
                for _ in range(tr["profile_steps"]):
                    with spans("step"):
                        step(next(feed))
                prof.stop()
                spans.profiling = ctx.kernels.recording = False
                profs.append(prof)
            prof_steps, steps_before = 2 * tr["profile_steps"], steps
            continue
        if spans is not None:
            with spans("step"):
                step(next(feed))
        else:
            step(next(feed))
        steps += 1
    harness.synchronize(dev)
    t1 = time.perf_counter()
    window = t1 - t0
    peak = harness.memory_peak(dev)

    layer = {}
    if ctx.traced:
        from portbench.trace import summarize

        lo, hi = (profs[0].host_s[0], profs[-1].host_s[1]) if profs else (0.0, 0.0)
        flops_mod = spec.load_module("configs", f"{ctx.config_name}_flops")
        dev_trace = summarize(profs[0].prof) if profs else None
        host_trace = summarize(profs[1].prof) if profs else None
        print(f"portbench: window {window:.3f} s, {steps_before} steps before the traced "
              f"stretches, {prof_steps} in them ({hi - lo:.3f} s), {steps - steps_before} after",
              file=sys.stderr)
        if dev_trace and steps and dev_trace["window_s"] > 0:
            busy_step = dev_trace["busy_s"] / tr["profile_steps"]
            untraced_step = (window - (hi - lo)) / steps
            print(f"portbench: idle {100 * (1 - dev_trace['busy_s'] / dev_trace['window_s']):.2f}% "
                  f"in the device-only stretch, {100 * (1 - busy_step / untraced_step):.2f}% "
                  f"from its device seconds a step ({busy_step * 1e3:.3f} ms) and the untraced "
                  f"step ({untraced_step * 1e3:.3f} ms); "
                  f"{100 * (1 - host_trace['busy_s'] / host_trace['window_s']):.2f}% in the "
                  "host-and-device stretch", file=sys.stderr)
        layer = {
            "steps": steps,
            "profiled_steps": tr["profile_steps"],
            "untraced_s": window - (hi - lo),
            "step_spans": spans.durations("step", (lo, hi)),
            "flops_per_step": flops_mod.train_flops_per_pair(bs) * bs,
            "kernel_bound_s": dict(ctx.kernels.bound_s),
            "trace": dev_trace,
            "host_trace": host_trace,
        }
    del model, opt, chunks, feed
    harness.release(dev)

    t_ref = time.perf_counter()
    ref_losses, ref_grad, ref_change = reference_run(ctx, cfg, params0, state0, batches,
                                                     tf32=False)
    print(f"portbench: the reference's {CHECK_STEPS} steps took "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    prog_change = {**{k: (params3[k] - params0[k]).to(dev) for k in params0},
                   **{k: (state3[k] - state0[k]).to(dev) for k in state0}}
    numbers = checks.training_numbers(prog_losses, ref_losses,
                                      {k: v.to(dev) for k, v in first_grad.items()}, ref_grad,
                                      prog_change, ref_change)
    return {
        "e2e": {"train_pairs_per_s": (steps + prof_steps) * bs / window},
        "window_start": t0,
        "attempted": steps + prof_steps,
        "failed": 0,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "layer": layer,
    }


def reference_run(ctx, cfg, params0: dict, state0: dict, batches: list, tf32: bool) -> tuple:
    """The reference's three steps from the same weights, state and batches:
    ``(losses per step, first gradients, change of every leaf)``."""
    from portbench.reference.common import precision, train_steps

    dev = ctx.device
    ref = spec.load_module("reference", ctx.config_name)
    params = {k: v.to(dev, copy=True) for k, v in params0.items()}
    state = {k: v.to(dev, copy=True) for k, v in state0.items()}
    with precision(tf32):
        losses, grads = train_steps(
            ref, params, state, [{k: v.to(dev) for k, v in b.items()} for b in batches],
            ctx.seed, {"learning_rate": cfg.learning_rate, "beta1": cfg.beta1,
                       "beta2": cfg.beta2, "weight_decay": cfg.weight_decay})
    change = {**{k: params[k] - params0[k].to(dev) for k in params0},
              **{k: state[k] - state0[k].to(dev) for k in state0}}
    return losses, grads, change


def reference_inputs(ctx) -> tuple:
    """What the reference gets in a run of this seed, without the program's
    steps: ``(cfg, weights, state, the checked steps' batches)``."""
    cfg = harness.train_config(ctx.config)
    chunks = make_corpus(ctx.traffic, cfg, ctx.seed, ctx.device)
    model = harness.build_model(cfg, segments(ctx.traffic), ctx.seed, ctx.device)
    params0, state0 = weights.snapshot(model)
    feed = walk(chunks, ctx.traffic, cfg.batch_size, ctx.seed, ctx.device)
    batches = [host_batch(next(feed), ctx.device) for _ in range(CHECK_STEPS)]
    return cfg, params0, state0, batches


def host_batch(item, dev) -> dict:
    """The batch of one walk item, gathered by the benchmark, on the host."""
    chunk, _, _, idx, subs = item
    i, s = torch.from_numpy(idx).to(dev), torch.from_numpy(subs).to(dev)
    return {"eeg": chunk["eeg"][s, i].cpu(), "speech": chunk["speech"][i].cpu(),
            "ids": chunk["ids"][i].cpu()}
