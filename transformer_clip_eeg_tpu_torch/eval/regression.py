"""The envelope-regression evaluation suite.

Counterpart of ``transformer_clip_eeg_tpu/eval/regression.py``: the
reference's three regression procedures (ref
``train_clip_helper_functions.py:443-764`` sub-specific, ``:767-1103``
sub-independent, ``:208-380`` the ICASSP-2023 challenge), with the intended
semantics the JAX package implements on ``EEGWindowDataset.
iter_subject_windows`` (the reference's loader never yields the tuples its
regression code expects):

* frozen EEG-encoder embeddings over non-overlapping windows, on the
  model's device, nearest-neighbour upsampled by the encoder's stride and
  cropped or extended to the target length (ref ``:535-547``);
* a Conv1d(k=32) probe trained with the negative-Pearson loss, Adam lr 1e-3,
  250 epochs, patience 10, minibatches of 64 (ref ``:623-672``), best on
  validation;
* the challenge: 50%-overlap windows, the probe's prediction, Hann-window
  overlap-add with boundary correction, Pearson against the ground truth
  (ref ``:262,306-325,360``).

All of a block's per-subject probes train at once
(:func:`train_regression_probes_batched`): the S probes are one grouped
convolution (``groups=S``) and each subject keeps its own Adam step count,
row mask, best-on-validation state and early stop, as the JAX package's
vmapped program does.  Probe training runs on ``device`` (the card unless
the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.eval.labels import load_labels_regression_2023
from transformer_clip_eeg_tpu_torch.eval.match_mismatch import embed_in_chunks
from transformer_clip_eeg_tpu_torch.models.regression import RegressionModel, pearson_loss
from transformer_clip_eeg_tpu_torch.models.registry import resolve_device
from transformer_clip_eeg_tpu_torch.ops.layers import init_parameters, same_padding
from transformer_clip_eeg_tpu_torch.ops.windowing import mvn_normalize, overlap_add_hann
from transformer_clip_eeg_tpu_torch.train.checkpoint import (
    restore_params_only,
    save_params_only,
)
from transformer_clip_eeg_tpu_torch.train.loop import printf

Probe = Dict[str, torch.Tensor]  # a probe's state_dict: conv.weight, conv.bias


def _audio_story(path: str) -> str:
    return os.path.basename(path).split("_-_")[0]


def _env_audio_files(audio_files: Sequence[str], regress_to: str) -> List[str]:
    """The target-feature files (``regress_to``, e.g. env) of the stories in
    ``audio_files`` (which the CLI globbed for the training feature),
    from the same stimulus directories."""
    stories = {_audio_story(x) for x in audio_files}
    dirs = {os.path.dirname(x) for x in audio_files}
    out = []
    for d in dirs:
        for f in glob.glob(os.path.join(d, f"*_-_{regress_to}.npy")):
            if _audio_story(f) in stories:
                out.append(f)
    return sorted(out)


def match_time_length(embeddings: np.ndarray, target_len: int) -> np.ndarray:
    """Stride compensation (ref :535-547): nearest-neighbour upsample by the
    integer stride, then extend with the last value or crop to
    ``target_len``.  ``embeddings`` is ``[B, T, D]``."""
    t = embeddings.shape[1]
    if t == target_len:
        return embeddings
    stride = int(target_len / t)
    if stride > 1:
        embeddings = np.repeat(embeddings, stride, axis=1)
    t = embeddings.shape[1]
    if t < target_len:
        pad = np.repeat(embeddings[:, -1:, :], target_len - t, axis=1)
        embeddings = np.concatenate([embeddings, pad], axis=1)
    elif t > target_len:
        embeddings = embeddings[:, :target_len, :]
    return embeddings


def _encode_in_chunks(model, windows: np.ndarray, chunk: int = 128) -> np.ndarray:
    """The EEG encoder's raw output ``[N, T', D]`` for ``windows [N, T, 64]``,
    on the model's device."""
    from transformer_clip_eeg_tpu_torch.train.steps import make_encode_fn

    out_shape = model.eegModel.output_shape(windows.shape[1])
    device = next(model.parameters()).device
    return embed_in_chunks(make_encode_fn(model), windows, chunk, device, out_shape)


def extract_subject_embeddings(
    model,
    files: Sequence[str],
    audio_files: Sequence[str],
    window_length: int,
    regress_to: str = "env",
    batch_size: int = 128,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per subject, the frozen EEG embeddings and the aligned target:
    ``{subject: (embeddings [N, T, D], target [N, T, 1])}``."""
    model.eval()
    env_files = _env_audio_files(audio_files, regress_to)
    dataset = EEGWindowDataset(list(files), env_files, window_length, window_length,
                               batch_size=batch_size)
    per_subject: Dict[str, List] = {}
    for sub, _key, eeg, feats in dataset.iter_subject_windows():
        if regress_to not in feats:
            continue
        env = feats[regress_to]
        if env.ndim == 4:  # ref :568-570 prunes a trailing singleton
            env = env[:, :, :, 0]
        emb = _encode_in_chunks(model, eeg.astype(np.float32))
        env = env[: emb.shape[0]]
        emb = match_time_length(emb, env.shape[1])
        per_subject.setdefault(sub, []).append((emb, env.astype(np.float32)))
    return {
        sub: (np.concatenate([e for e, _ in pairs], axis=0),
              np.concatenate([v for _, v in pairs], axis=0))
        for sub, pairs in per_subject.items()
    }


def _cached_extract(cache: Optional[dict], model, files, audio_files, wl: int,
                    regress_to: str, batch_size: int):
    """``extract_subject_embeddings`` behind an optional caller-owned cache:
    the sub-specific and sub-independent blocks embed the same corpus, so
    the CLI shares one dict between them.  Keyed on everything that affects
    the output."""
    if cache is None:
        return extract_subject_embeddings(model, files, audio_files, wl, regress_to, batch_size)
    key = (tuple(files), tuple(audio_files), wl, regress_to, batch_size)
    if key not in cache:
        cache[key] = extract_subject_embeddings(model, files, audio_files, wl, regress_to,
                                                batch_size)
    return cache[key]


# ---------------------------------------------------------------------------
# Probe training (ref :623-672)
# ---------------------------------------------------------------------------


def _init_probe(input_dim: int, out_dim: int, seed: int,
                init_params: Optional[Probe]) -> RegressionModel:
    """A probe with ``init_params`` (e.g. the JAX package's initial params
    through ``utils.convert.state_dict_from_jax``) or with torch's default
    init drawn from ``torch.Generator().manual_seed(seed)``."""
    model = RegressionModel(input_dim, out_dim)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _as_probe(weight: torch.Tensor, bias: torch.Tensor) -> Probe:
    return {"conv.weight": weight.detach().cpu().clone(), "conv.bias": bias.detach().cpu().clone()}


def train_regression_probe(
    train_emb: np.ndarray,
    train_env: np.ndarray,
    val_emb: np.ndarray,
    val_env: np.ndarray,
    *,
    epochs: int = 250,
    patience: int = 10,
    batch_size: int = 64,
    lr: float = 1e-3,
    loss_file: Optional[str] = None,
    seed: int = 0,
    init_params: Optional[Probe] = None,
    device="cuda",
) -> Tuple[Probe, float]:
    """Train one probe; returns ``(state_dict, best_val_loss)``.  The
    reference procedure (ref :623-672): Adam lr 1e-3, negative-Pearson loss,
    minibatches of 64 in order, best-on-validation, and a stop once the
    epoch is more than ``patience`` past the best."""
    dev = resolve_device(device)
    model = _init_probe(train_emb.shape[-1], train_env.shape[-1], seed, init_params).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    tr_emb, tr_env, va_emb, va_env = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                                      for a in (train_emb, train_env, val_emb, val_env))
    best_val, best_epoch = float("inf"), 0
    best_params = _as_probe(model.conv.weight, model.conv.bias)
    for epoch in range(epochs):
        train_losses = []
        for i in range(0, tr_emb.shape[0], batch_size):
            loss = pearson_loss(model(tr_emb[i:i + batch_size]), tr_env[i:i + batch_size]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            train_losses.append(float(loss.detach()))
        with torch.no_grad():
            val_losses = [float(pearson_loss(model(va_emb[i:i + batch_size]),
                                             va_env[i:i + batch_size]).mean())
                          for i in range(0, va_emb.shape[0], batch_size)]
        val_loss = float(np.mean(val_losses))
        if loss_file:
            printf(f"epoch {epoch}, loss {np.mean(train_losses)}, val_loss {val_loss}", loss_file)
        if val_loss < best_val:
            best_val, best_epoch = val_loss, epoch
            best_params = _as_probe(model.conv.weight, model.conv.bias)
        elif epoch - best_epoch > patience:
            break
    return best_params, best_val


def _batched_probe(w: torch.Tensor, b: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """S probes at once as one grouped convolution: weights ``w [S, O, I, K]``,
    ``b [S, O]``, inputs ``emb [S, B, T, I]`` → ``[S, B, T, O]``."""
    s, o, i, k = w.shape
    bs, t = emb.shape[1], emb.shape[2]
    x = F.pad(emb.permute(1, 0, 3, 2).reshape(bs, s * i, t), same_padding(k, 1))
    y = F.conv1d(x, w.reshape(s * o, i, k), b.reshape(s * o), groups=s)
    return F.leaky_relu(y.reshape(bs, s, o, t).permute(1, 0, 3, 2), 0.01)


def _masked_batch_pearson(w, b, emb_b, env_b, row_mask) -> torch.Tensor:
    """Per subject, the negative Pearson over its valid rows (``row_mask
    [S, B]``), then its channels: ``[S]``, equal to ``pearson_loss(...).mean()``
    on the unpadded batch."""
    out = _batched_probe(w, b, emb_b)
    # a padded row is constant over time, whose zero norm would make the
    # gradient NaN: a ramp stands in for it (it is masked out of the loss)
    ramp = torch.arange(out.shape[2], dtype=out.dtype, device=out.device).view(1, 1, -1, 1)
    out = torch.where(row_mask[:, :, None, None] > 0, out, ramp)
    xc = out - out.mean(2, keepdim=True)
    yc = env_b - env_b.mean(2, keepdim=True)
    num = (xc * yc).sum(2)
    den = (torch.linalg.vector_norm(xc, dim=2).clamp(min=1e-6)
           * torch.linalg.vector_norm(yc, dim=2).clamp(min=1e-6))
    r = num / den  # [S, B, O]
    cnt = row_mask.sum(1)
    return -(r * row_mask[:, :, None]).sum((1, 2)) / (cnt * r.shape[2]).clamp(min=1.0)


def train_regression_probes_batched(
    subjects: Sequence[str],
    train_by_sub: Dict[str, Tuple[np.ndarray, np.ndarray]],
    val_by_sub: Dict[str, Tuple[np.ndarray, np.ndarray]],
    *,
    epochs: int = 250,
    patience: int = 10,
    batch_size: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    init_params: Optional[Probe] = None,
    device="cuda",
) -> Dict[str, Tuple[Probe, float]]:
    """Train every subject's probe at once; returns ``{subject: (state_dict,
    best_val_loss)}``, per subject the result :func:`train_regression_probe`
    gives.  Subjects are end-padded to the longest (rounded up to
    ``batch_size``) and masked: a subject's minibatch boundaries, per-batch
    loss means, the unweighted mean of its validation batch means, its best
    on validation and its early stop are its own.  Adam's step count is per
    subject: a subject whose minibatch is past its end, or who has stopped,
    takes no step and does not advance it.  Every probe starts from the same
    initial params (``init_params``, or drawn from ``seed``)."""
    s_n = len(subjects)
    if s_n == 0:
        raise ValueError("no subjects to train probes for")
    dev = resolve_device(device)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def stack(by_sub):
        pairs = [by_sub[s] for s in subjects]
        ns = np.array([p[0].shape[0] for p in pairs], np.int64)
        nmax = int(-(-max(ns) // batch_size) * batch_size)
        emb = np.zeros((s_n, nmax) + pairs[0][0].shape[1:], np.float32)
        env = np.zeros((s_n, nmax) + pairs[0][1].shape[1:], np.float32)
        for i, (e, v) in enumerate(pairs):
            emb[i, : e.shape[0]] = e
            env[i, : v.shape[0]] = v
        return (torch.from_numpy(emb).to(dev), torch.from_numpy(env).to(dev),
                torch.from_numpy(ns).to(dev))

    tr_emb, tr_env, tr_n = stack(train_by_sub)
    va_emb, va_env, va_n = stack(val_by_sub)
    probe = _init_probe(tr_emb.shape[-1], tr_env.shape[-1], seed, init_params)
    params = [p.detach().to(dev).unsqueeze(0).repeat((s_n,) + (1,) * p.dim())
              for p in (probe.conv.weight, probe.conv.bias)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    count = torch.zeros(s_n, dtype=torch.int64, device=dev)
    best = [p.clone() for p in params]
    best_val = torch.full((s_n,), float("inf"), device=dev)
    best_epoch = torch.zeros(s_n, dtype=torch.int64, device=dev)
    done = torch.zeros(s_n, dtype=torch.bool, device=dev)
    rows = torch.arange(batch_size, device=dev)

    def per_subject(mask: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return mask.view((s_n,) + (1,) * (p.dim() - 1))

    def mask_rows(start: int, n: torch.Tensor) -> torch.Tensor:
        return ((start + rows)[None, :] < n[:, None]).to(torch.float32)

    for epoch in range(epochs):
        if bool(done.all()):
            break
        for start in range(0, tr_emb.shape[1], batch_size):
            row_mask = mask_rows(start, tr_n)
            valid = (start < tr_n) & ~done
            w, b = (p.requires_grad_(True) for p in params)
            loss = _masked_batch_pearson(w, b, tr_emb[:, start:start + batch_size],
                                         tr_env[:, start:start + batch_size], row_mask)
            grads = torch.autograd.grad(loss.sum(), [w, b])
            with torch.no_grad():
                count = count + valid.to(torch.int64)
                t = count.clamp(min=1).to(torch.float32)
                for j, (p, g) in enumerate(zip(params, grads)):
                    m_new = b1 * mu[j] + (1.0 - b1) * g
                    v_new = b2 * nu[j] + (1.0 - b2) * g * g
                    m_hat = m_new / per_subject(1.0 - b1 ** t, p)
                    v_hat = v_new / per_subject(1.0 - b2 ** t, p)
                    p_new = p - lr * m_hat / (torch.sqrt(v_hat) + eps)
                    keep = per_subject(valid, p)
                    params[j] = torch.where(keep, p_new, p.detach())
                    mu[j] = torch.where(keep, m_new, mu[j])
                    nu[j] = torch.where(keep, v_new, nu[j])
        with torch.no_grad():
            total = torch.zeros(s_n, device=dev)
            n_valid = torch.zeros(s_n, device=dev)
            for start in range(0, va_emb.shape[1], batch_size):
                batch_loss = _masked_batch_pearson(*params, va_emb[:, start:start + batch_size],
                                                   va_env[:, start:start + batch_size],
                                                   mask_rows(start, va_n))
                has_rows = (start < va_n).to(torch.float32)
                total += batch_loss * has_rows
                n_valid += has_rows
            # the reference's unweighted mean of per-batch means (ref :196-201)
            val = total / n_valid.clamp(min=1.0)
            live = ~done
            improved = (val < best_val) & live
            for j, p in enumerate(params):
                best[j] = torch.where(per_subject(improved, p), p, best[j])
            # the patience test is the elif of the improvement test, against
            # the best epoch from before this one (ref :208-214)
            stop = ~improved & (epoch - best_epoch > patience)
            best_val = torch.where(improved, val, best_val)
            best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
            done = done | (stop & live)
    best_val = best_val.cpu()
    return {s: (_as_probe(best[0][i], best[1][i]), float(best_val[i]))
            for i, s in enumerate(subjects)}


def _probe_test_loss(params: Probe, emb: np.ndarray, env: np.ndarray, device) -> float:
    probe = RegressionModel.from_state_dict(params, device)
    with torch.no_grad():
        out = probe(torch.from_numpy(np.asarray(emb, np.float32)).to(device))
        return float(pearson_loss(out, torch.from_numpy(np.asarray(env, np.float32)).to(device)
                                  ).mean())


# ---------------------------------------------------------------------------
# Sub-specific (ref :443-764)
# ---------------------------------------------------------------------------


def evaluate_model_do_regression_sub_specific(
    model, train_files, val_files, test_files, train_files_audio, val_files_audio,
    test_files_audio, result_folder: str, regress_to: str = "env", window_length: int = 3,
    fs: int = 64, batch_size: int = 128, embeddings_cache: Optional[dict] = None,
) -> Dict[str, float]:
    """A probe per subject; returns ``{subject: test negative-Pearson loss}``,
    writes ``evaluation_regression.json`` and the probes under
    ``sub_specific/`` (ref :443-764).  If training all probes at once fails,
    each subject is trained on its own and the failure is written to
    ``error_regression.txt``.  ``embeddings_cache``: a dict shared with the
    sub-independent block, so the corpus is embedded once."""
    os.makedirs(os.path.join(result_folder, "sub_specific"), exist_ok=True)
    device = next(model.parameters()).device
    wl = window_length * fs
    evaluation: Dict[str, float] = {}
    extract = lambda files, audio: _cached_extract(  # noqa: E731
        embeddings_cache, model, files, audio, wl, regress_to, batch_size)
    train_by_sub = extract(train_files, train_files_audio)
    val_by_sub = extract(val_files, val_files_audio)
    test_by_sub = extract(test_files, test_files_audio)

    print(f"number of subjects {len(train_by_sub)}")
    subjects = []
    for sub in train_by_sub:
        if sub not in test_by_sub:
            print(f"subject {sub} has no test files")
            continue
        subjects.append(sub)
    if not subjects:
        return evaluation

    # validation falls back to test for a subject without val files (ref :489-491)
    resolved_val = {sub: val_by_sub.get(sub, test_by_sub[sub]) for sub in subjects}
    file_loss = os.path.join(result_folder, "loss_regression.txt")
    file_error = os.path.join(result_folder, "error_regression.txt")
    try:
        trained = train_regression_probes_batched(subjects, train_by_sub, resolved_val,
                                                  device=device)
    except Exception as e:  # noqa: BLE001 - one subject must not cost every probe
        printf(f"batched probe training failed ({type(e).__name__}: {e}); "
               "falling back to sequential per-subject training", file_error)
        trained = {}
        for sub in subjects:
            try:
                trained[sub] = train_regression_probe(*train_by_sub[sub], *resolved_val[sub],
                                                      loss_file=file_loss, device=device)
            except Exception as se:  # noqa: BLE001 - per-subject resilience (ref :759-763)
                printf(f"error with subject {sub}", file_error)
                printf(str(se), file_error)
        subjects = [s for s in subjects if s in trained]

    for sub in subjects:
        try:
            print(f"subject {sub}")
            probe_params, best_val = trained[sub]
            # the reference streams per-epoch probe losses (ref :628-651);
            # training all at once records each subject's outcome instead
            printf(f"subject {sub} probe best val loss {best_val}", file_loss)
            save_params_only(os.path.join(result_folder, "sub_specific",
                                          f"regression_model_{sub}"), probe_params)
            evaluation[sub] = _probe_test_loss(probe_params, *test_by_sub[sub], device)
            print(f"evaluation for subject {sub} is {evaluation[sub]}")
            with open(os.path.join(result_folder, "evaluation_regression.json"), "w") as f:
                json.dump(evaluation, f)
        except Exception as e:  # noqa: BLE001 - per-subject resilience (ref :759-763)
            printf(f"error with subject {sub}", file_error)
            printf(str(e), file_error)
    return evaluation


# ---------------------------------------------------------------------------
# Sub-independent (ref :767-1103)
# ---------------------------------------------------------------------------


def evaluate_model_do_regression_sub_independent(
    model, train_files, val_files, test_files, train_files_audio, val_files_audio,
    test_files_audio, result_folder: str, regress_to: str = "env", window_length: int = 3,
    fs: int = 64, batch_size: int = 128, embeddings_cache: Optional[dict] = None,
) -> Dict[str, float]:
    """One probe over all subjects; per-subject test losses →
    ``evaluation_regression_general_model_env.json`` (ref :767-1103).  An
    existing ``regression_model_general_env`` is loaded, not retrained (ref
    :813)."""
    device = next(model.parameters()).device
    wl = window_length * fs
    evaluation: Dict[str, float] = {}
    probe_path = os.path.join(result_folder, f"regression_model_general_{regress_to}")
    extract = lambda files, audio: _cached_extract(  # noqa: E731
        embeddings_cache, model, files, audio, wl, regress_to, batch_size)
    train_by_sub = extract(train_files, train_files_audio)
    val_by_sub = extract(val_files, val_files_audio)
    test_by_sub = extract(test_files, test_files_audio)
    if not train_by_sub:
        print("no training data for sub-independent regression")
        return evaluation

    if os.path.exists(probe_path):
        probe_params = restore_params_only(probe_path)
        print(f"loaded general probe from {probe_path}")
    else:
        tr_emb = np.concatenate([e for e, _ in train_by_sub.values()], axis=0)
        tr_env = np.concatenate([v for _, v in train_by_sub.values()], axis=0)
        held = val_by_sub or test_by_sub
        val_emb = np.concatenate([e for e, _ in held.values()], axis=0)
        val_env = np.concatenate([v for _, v in held.values()], axis=0)
        trained = train_regression_probes_batched(
            ["general"], {"general": (tr_emb, tr_env)}, {"general": (val_emb, val_env)},
            device=device)
        probe_params, best_val = trained["general"]
        printf(f"general probe best val loss {best_val}",
               os.path.join(result_folder, f"loss_regression_general_{regress_to}.txt"))
        save_params_only(probe_path, probe_params)

    for sub, (te_emb, te_env) in test_by_sub.items():
        evaluation[sub] = _probe_test_loss(probe_params, te_emb, te_env, device)
        print(f"evaluation for subject {sub} is {evaluation[sub]}")
        with open(os.path.join(result_folder,
                               f"evaluation_regression_general_model_{regress_to}.json"),
                  "w") as f:
            json.dump(evaluation, f)
    return evaluation


# ---------------------------------------------------------------------------
# ICASSP-2023 challenge regression (ref :208-380)
# ---------------------------------------------------------------------------


def hann_overlap_add(predictions: np.ndarray, time_window: int, time_dim: int) -> np.ndarray:
    """Hann-window overlap-add with boundary correction (ref :306-325) of
    ``[n_windows, time_window]`` predictions from 50%-overlap windows: the
    first half of the first window and the last half of the last get unit
    weight, so the reconstruction is exact at the boundaries."""
    return overlap_add_hann(torch.from_numpy(np.asarray(predictions, np.float32)),
                            time_dim, time_window).numpy()


def _pearson_np(x: np.ndarray, y: np.ndarray) -> float:
    xc = x - x.mean()
    yc = y - y.mean()
    return float((xc @ yc) / (np.linalg.norm(xc) * np.linalg.norm(yc) + 1e-12))


def evaluate_model_challenge_2023_regression(
    model, results_folder: str, eeg_folder: str, subject: Optional[str] = None,
) -> Tuple[Dict, Dict]:
    """ICASSP task 2 (ref :208-380): the probe predicts the envelope of each
    50%-overlap window, the windows are overlap-added with a Hann window, and
    the Pearson r against the ground truth is averaged per subject.  Returns
    ``({subject: mean r with the general probe}, {subject: mean r with its
    own probe, where one exists})`` and writes the predictions under
    ``regression_2023_icassp/``."""
    model.eval()
    device = next(model.parameters()).device
    labels_regression = load_labels_regression_2023(os.path.join(eeg_folder, "labels"),
                                                    subject=subject)
    if not labels_regression:
        print("No labels found for regression evaluation, skipping.")
        return {}, {}

    time_dim = len(list(labels_regression.values())[0][0])
    time_window = int(model.window_length)
    # the general probe is required (ref :225-231), a subject's own optional;
    # each probe's shape is read from its checkpoint
    general = RegressionModel.from_state_dict(
        restore_params_only(os.path.join(results_folder, "regression_model_general_env")),
        device)
    evaluation: Dict[str, float] = {}
    evaluation_sub_specific: Dict[str, float] = {}
    if subject is not None:
        test_eeg_mapping = [os.path.join(eeg_folder, f"{subject}.json")]
    else:
        test_eeg_mapping = glob.glob(os.path.join(eeg_folder, "sub*.json"))
    out_dir = os.path.join(results_folder, "regression_2023_icassp")
    os.makedirs(out_dir, exist_ok=True)

    for sub_data_path in test_eeg_mapping:
        subject_name = os.path.basename(sub_data_path).split(".")[0]
        sub_probe_path = os.path.join(results_folder, "sub_specific",
                                      f"regression_model_{subject_name}")
        print(f"evaluating {subject_name}")
        try:
            with open(sub_data_path) as f:
                sub_data = json.load(f)
        except (OSError, ValueError):
            print(f"error with {sub_data_path}")
            continue
        id_list = list(sub_data.keys())
        data_eeg = np.squeeze(np.stack([sub_data[key] for key in id_list])).astype(np.float32)
        if data_eeg.ndim == 2:
            data_eeg = data_eeg[None]
        # trials x time x channels, MVN over (trial, time) (ref :255-261)
        data_eeg_mvn = mvn_normalize(torch.from_numpy(data_eeg)).numpy()

        # 50%-overlap windows, the ragged last dropped (ref :262)
        hop = time_window // 2
        windows = np.stack([data_eeg_mvn[:, i:i + time_window]
                            for i in range(0, data_eeg_mvn.shape[1], hop)][:-1])
        windows = np.transpose(windows, (1, 0, 2, 3))  # [n_trials, n_win, wl, C]
        nt, nw = windows.shape[0], windows.shape[1]
        emb = _encode_in_chunks(model, windows.reshape((nt * nw,) + windows.shape[2:]))
        emb = torch.from_numpy(match_time_length(emb, time_window)).to(device)

        def reconstruct(probe) -> List[np.ndarray]:
            with torch.no_grad():
                pred = probe(emb).squeeze(-1).reshape(nt, nw, time_window)
                return [overlap_add_hann(p, time_dim, time_window).cpu().numpy() for p in pred]

        final_outputs = reconstruct(general)
        sub_probe = (RegressionModel.from_state_dict(restore_params_only(sub_probe_path), device)
                     if os.path.exists(sub_probe_path) else None)
        labels_in_order = [labels_regression[x] for x in id_list]
        truth = [np.squeeze(np.array(lab[0])) for lab in labels_in_order]
        evaluation[subject_name] = float(np.mean(
            [_pearson_np(final_outputs[i], truth[i]) for i in range(len(truth))]))
        print(f"evaluation regression: {evaluation[subject_name]}, {subject_name}")
        with open(os.path.join(out_dir, f"{subject_name}_predictions.json"), "w") as f:
            json.dump({key: final_outputs[i].tolist() for i, key in enumerate(id_list)}, f)

        if sub_probe is not None:
            outputs_sub = reconstruct(sub_probe)
            evaluation_sub_specific[subject_name] = float(np.mean(
                [_pearson_np(outputs_sub[i], truth[i]) for i in range(len(truth))]))
            with open(os.path.join(out_dir, f"{subject_name}_predictions_sub_specific.json"),
                      "w") as f:
                json.dump({key: outputs_sub[i].tolist() for i, key in enumerate(id_list)}, f)

    return evaluation, evaluation_sub_specific
