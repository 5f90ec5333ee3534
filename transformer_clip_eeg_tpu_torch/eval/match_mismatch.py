"""ICASSP-2023 task-1 match-mismatch and top-X retrieval evaluation.

Counterpart of ``transformer_clip_eeg_tpu/eval/match_mismatch.py`` (ref
``train_clip_helper_functions.py:51-205``):

* every candidate stimulus segment is embedded once (speech encoder,
  flatten, L2-normalise) on the model's device, in fixed-size chunks;
* per subject, the trial EEG of ``sub*.json`` is stacked, MVN-normalised over
  the (segments, time) axes (ref ``:136``) and embedded, then
  - the 2-candidate accuracy is the argmax over the two similarities (ref
    ``:159-164``),
  - the top-X retrieval (X = 1..100) ranks all stimuli by one matmul (ref
    ``:176-202``).

The similarities, ``argmax`` and ``argsort`` run in numpy on the host, as in
the JAX package, so ties break the same way.  ``embed_in_chunks`` also
serves ``serve.InferenceSession`` and the regression evals.  Under a
data-parallel mesh (the model's, ``parallel.attach``) the embedding
functions split each chunk over the ranks and gather the rows back
(``train/steps.make_embed_fns``, JAX's ``mesh_embed_setup``), so every rank
gets every embedding and runs the rest of the suite as one process does.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.eval.labels import load_labels_match_mismatch_2023
from transformer_clip_eeg_tpu_torch.models.heads import embedding_width


def embed_in_chunks(
    embed_fn: Callable,
    data: np.ndarray,
    chunk: int,
    device: torch.device,
    out_shape: Union[int, Sequence[int]],
) -> np.ndarray:
    """Apply ``embed_fn`` to ``data [N, ...]`` in fixed-size chunks, the last
    one zero-padded, on ``device``; returns ``[N, *out_shape]`` float32.
    N = 0 gives ``[0, *out_shape]`` without running the model."""
    n = data.shape[0]
    if n == 0:
        shape = (out_shape,) if isinstance(out_shape, int) else tuple(out_shape)
        return np.zeros((0,) + shape, np.float32)
    pad = (-n) % chunk
    if pad:
        data = np.concatenate([data, np.zeros((pad,) + data.shape[1:], data.dtype)])
    outs = []
    for i in range(0, data.shape[0], chunk):
        x = torch.from_numpy(np.ascontiguousarray(data[i:i + chunk])).to(device)
        outs.append(embed_fn(x).cpu().numpy())
    return np.concatenate(outs, axis=0)[:n]


def evaluate_model_challenge_2023_mm(
    model,
    eeg_folder: str,
    speech_feature: str = "wav2vec_19",
    subject: Optional[str] = None,
    chunk: int = 128,
) -> Tuple[Dict, Dict, Dict, Dict]:
    """Returns the (accuracy, logits, top_x, top_x_logits) dicts keyed by
    subject (ref train_clip_helper_functions.py:51-205); the embeddings run
    on the device ``model`` lies on."""
    from transformer_clip_eeg_tpu_torch.train.steps import make_embed_fns

    model.eval()
    device = next(model.parameters()).device
    embed_eeg, embed_speech = make_embed_fns(model)

    # the folder name is fixed whatever the feature (ref :58)
    stimulus_folder = os.path.join(eeg_folder, "wav2vec_segments_wholefile_64hz")
    all_groundtruth_labels = load_labels_match_mismatch_2023(os.path.join(eeg_folder, "labels"))
    if subject is not None:
        test_eeg_mapping = [os.path.join(eeg_folder, f"{subject}.json")]
    else:
        test_eeg_mapping = glob.glob(os.path.join(eeg_folder, "sub*.json"))
    test_stimuli = glob.glob(os.path.join(stimulus_folder, f"*{speech_feature}*.pkl"))

    # embed all candidate stimuli once (ref :92-108)
    test_stimuli_embeddings: Dict[str, np.ndarray] = {}
    for stimulus_path in test_stimuli:
        with open(stimulus_path, "rb") as f:
            data = pickle.load(f)
        keys = list(data.keys())
        # the last segment of a file may be ragged; drop it (ref :99-100)
        if len(keys) >= 2 and data[keys[-1]].shape != data[keys[-2]].shape:
            keys = keys[:-1]
        segments = np.stack([data[key] for key in keys]).astype(np.float32)
        dim = embedding_width(model.speechModel, segments.shape[1])
        embeddings = embed_in_chunks(embed_speech, segments, chunk, device, dim)
        test_stimuli_embeddings.update({key: embeddings[i] for i, key in enumerate(keys)})

    evaluation: Dict = {}
    evaluation_with_logits: Dict = {}
    evaluation_top_x: Dict = {}
    evaluation_top_x_with_logits: Dict = {}

    list_keys_stimuli = list(test_stimuli_embeddings.keys())
    if not list_keys_stimuli:
        print("No test stimuli found for match-mismatch evaluation, skipping.")
        return {}, {}, {}, {}
    all_stimuli_matrix = np.stack([test_stimuli_embeddings[k] for k in list_keys_stimuli])

    for sub_stimulus_mapping_path in test_eeg_mapping:
        subject_name = os.path.basename(sub_stimulus_mapping_path).split(".")[0]
        try:
            with open(sub_stimulus_mapping_path) as f:
                sub_stimulus_mapping = json.load(f)
        except (OSError, ValueError):
            print(f"error with {sub_stimulus_mapping_path}")
            continue
        id_list = list(sub_stimulus_mapping.keys())

        data_eeg = np.squeeze(
            np.stack([sub_stimulus_mapping[key][0] for key in id_list])).astype(np.float32)
        # MVN over (segments, time): the eval normalisation contract (ref :136)
        data_eeg_mvn = (data_eeg - np.mean(data_eeg, axis=(0, 1), keepdims=True)) / np.std(
            data_eeg, axis=(0, 1), keepdims=True)

        labels_in_order = [all_groundtruth_labels[x] for x in id_list]
        correct_keys = [
            sub_stimulus_mapping[key][all_groundtruth_labels[key] + 1].split(".")[0]
            for key in id_list
        ]
        dim = embedding_width(model.eegModel, data_eeg_mvn.shape[1])
        eeg_embeddings = embed_in_chunks(embed_eeg, data_eeg_mvn, chunk, device, dim)

        # 2-candidate accuracy (ref :153-164): diag(eeg @ candidate_j.T)
        cand = np.stack([
            np.stack([test_stimuli_embeddings[sub_stimulus_mapping[key][j].split(".")[0]]
                      for j in (1, 2)])
            for key in id_list
        ])  # [n_trials, 2, D]
        speech_eeg_logits = np.einsum("nd,njd->jn", eeg_embeddings, cand)
        max_sim = np.argmax(speech_eeg_logits, axis=0)
        accuracy = float(np.mean(max_sim == np.asarray(labels_in_order)))
        evaluation[subject_name + "_mvn"] = accuracy
        print(f"evaluation mm with mvn : {accuracy}, {subject_name}")

        evaluation_with_logits[subject_name] = {
            key: (speech_eeg_logits[:, i].tolist(), labels_in_order[i])
            for i, key in enumerate(id_list)
        }

        # top-X retrieval against all stimuli (ref :176-202)
        correct_keys_idx = np.asarray([list_keys_stimuli.index(x) for x in correct_keys],
                                      dtype=np.int32)
        logits = eeg_embeddings @ all_stimuli_matrix.T
        maxtop = min(100, logits.shape[1])
        topk_idx = np.argsort(-logits, axis=1)[:, :maxtop]
        labels_rep = np.reshape(np.repeat(correct_keys_idx, maxtop), (len(correct_keys_idx), -1))
        correct_top = np.mean(np.cumsum(np.equal(labels_rep, topk_idx), axis=1), axis=0)
        evaluation_top_x[subject_name] = correct_top.tolist()
        evaluation_top_x_with_logits[subject_name] = {
            "logits": logits.tolist(),
            "correct_keys_idx": correct_keys_idx.tolist(),
            "correct_top": correct_top.tolist(),
        }
        print(f"evaluation mm top x: {subject_name} : top1 {correct_top[0] * 100}, top10: "
              f"{correct_top[min(9, maxtop - 1)] * 100}")

    return evaluation, evaluation_with_logits, evaluation_top_x, evaluation_top_x_with_logits
