"""The wav2vec2 speech encoder (XLSR-53 architecture) for stimulus features.

Counterpart of ``transformer_clip_eeg_tpu/models/wav2vec2.py``.  The
reference extracts layer-19 hidden states of
``jonatasgrosman/wav2vec2-large-xlsr-53-dutch`` with HuggingFace torch (ref
``create_wav2vec.py:11-23,94-109``); this is the same architecture in plain
PyTorch, without ``transformers``:

* the conv feature encoder (7 strided convs, each with a LayerNorm over its
  channels and exact GELU: ``feat_extract_norm='layer'``),
* the feature projection (LayerNorm → Linear 512→1024),
* the grouped positional conv embedding (128 taps, 16 groups; the weight
  norm folded into a plain weight when loading; an even kernel drops its
  last output, as HF's ``Wav2Vec2SamePadLayer``),
* the pre-LN ("stable layer norm") transformer stack, 24 layers, d=1024, 16
  heads, FFN 4096, attention as ``softmax(q kᵀ) v`` with f32 scores,
* an early exit at the tap layer: ``tap_layer=i`` is HF's
  ``hidden_states[i]`` (0: the input after the positional conv; the last
  layer's adds the final ``layer_norm``), and layers past the deepest tap
  are never run.

Every part is a cuDNN convolution, a cuBLAS product or an elementwise op: the
JAX package computes it in plain XLA ops, no Pallas kernel lies on this
path, and the port writes none for it.  Parameters carry HF's
``Wav2Vec2Model.state_dict()`` names, so an HF checkpoint loads without
renaming (:func:`convert_hf_wav2vec2` strips the ``wav2vec2.`` prefix and
folds the weight norm; :func:`read_hf_directory` reads ``config.json`` and
``pytorch_model.bin`` or ``model.safetensors`` without ``transformers``).

``dtype``: the compute dtype.  In bfloat16 the parameters stay float32 and
are cast at each use, as flax's ``dtype`` does; LayerNorm statistics and the
attention scores and softmax run in float32; the output is float32.

``tp_group``: a ``torch.distributed`` group of ``n`` ranks over which the
encoder layers are Megatron-sharded (``parallel/tp.py``, inference only).
Each rank's attention holds ``num_attention_heads / n`` heads and its FFN
``intermediate_size / n`` hidden units; the partial sums of ``out_proj``
and ``output_dense`` are all-reduced over the group in float32, then the
bias is added and the result cast to the compute dtype.  Without a group
the forward is the single-device one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import _conv1d_low, low_precision, upcast


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (defaults = XLSR-53 large)."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 3, 2)
    conv_bias: bool = True
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible by "
                             f"num_attention_heads {self.num_attention_heads}")
        if not len(self.conv_dim) == len(self.conv_stride) == len(self.conv_kernel):
            raise ValueError("conv_dim/conv_stride/conv_kernel length mismatch")

    @classmethod
    def from_hf(cls, hf_config) -> "Wav2Vec2Config":
        """From an HF ``config.json`` dict or an HF config object.  Raises
        ``ValueError`` for the variants this architecture is not: a
        group-norm feature encoder or post-LN layers."""
        get = hf_config.get if isinstance(hf_config, Mapping) else \
            lambda k, d=None: getattr(hf_config, k, d)
        if get("feat_extract_norm", "layer") != "layer" or not get("do_stable_layer_norm", True):
            raise ValueError("only feat_extract_norm='layer' with do_stable_layer_norm=True "
                             "(the XLSR-53 large layout) is built")
        return cls(
            conv_dim=tuple(get("conv_dim")),
            conv_stride=tuple(get("conv_stride")),
            conv_kernel=tuple(get("conv_kernel")),
            conv_bias=bool(get("conv_bias")),
            hidden_size=get("hidden_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            num_conv_pos_embeddings=get("num_conv_pos_embeddings"),
            num_conv_pos_embedding_groups=get("num_conv_pos_embedding_groups"),
            layer_norm_eps=get("layer_norm_eps"),
        )

    def to_hf_dict(self) -> Dict[str, Any]:
        """The ``config.json`` entries HF's ``Wav2Vec2Config`` reads for this
        architecture."""
        return dict(dataclasses.asdict(self), conv_dim=list(self.conv_dim),
                    conv_stride=list(self.conv_stride), conv_kernel=list(self.conv_kernel),
                    feat_extract_norm="layer", do_stable_layer_norm=True,
                    feat_extract_activation="gelu", hidden_act="gelu",
                    model_type="wav2vec2", architectures=["Wav2Vec2ForCTC"])


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    if not low_precision(x):
        return F.linear(x, layer.weight, layer.bias)
    y = F.linear(x, layer.weight.to(x.dtype))  # rounded, then the bias added, as flax
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def _tp_all_reduce(y: torch.Tensor, group) -> None:
    """The sum of ``y`` over the tensor-parallel ``group``, in place."""
    dist.all_reduce(y, group=group)


def _row_parallel_linear(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """A row-sharded product: this rank's partial sum in float32, summed over
    ``group``, then the whole bias, cast back to ``x.dtype`` (the plain
    ``_linear`` without a group)."""
    if group is None:
        return _linear(x, layer)
    y = upcast(F.linear(x, layer.weight.to(x.dtype)))
    _tp_all_reduce(y, group)
    return (y + layer.bias).to(x.dtype)


def _tp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _conv(x: torch.Tensor, conv: nn.Conv1d, padding: int = 0) -> torch.Tensor:
    kw = dict(stride=conv.stride, padding=padding, groups=conv.groups)
    if not low_precision(x):
        return F.conv1d(x, conv.weight, conv.bias, **kw)
    bias = conv.weight.new_zeros(conv.out_channels) if conv.bias is None else conv.bias
    return _conv1d_low(x, conv.weight, bias, **kw)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax's LayerNorm at ``x.dtype``: for bf16 the statistics and affine in
    float32, the result in bf16."""
    y = F.layer_norm(upcast(x), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(x.dtype)


class _ConvLayer(nn.Module):
    """One feature-encoder conv: valid strided Conv1d, LayerNorm over the
    channels, exact GELU; ``[B, C_in, T]`` → ``[B, C_out, T']``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(_conv(x, self.conv).transpose(1, 2), self.layer_norm)
        return F.gelu(h).transpose(1, 2)


class FeatureEncoder(nn.Module):
    """The strided conv stack: raw audio ``[B, T]`` → ``[B, frames, C]``."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, cfg.conv_bias, cfg.layer_norm_eps)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        h = audio[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(_layer_norm(x, self.layer_norm), self.projection)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding with ``k // 2`` zero pad on each
    side; an even kernel drops the last output; exact GELU."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, cfg.num_conv_pos_embeddings,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.conv.kernel_size[0]
        h = _conv(x.transpose(1, 2), self.conv, padding=k // 2)
        if k % 2 == 0:
            h = h[:, :, :-1]
        return F.gelu(h).transpose(1, 2)


class Attention(nn.Module):
    """Self-attention; with ``tp_group`` this rank's ``1 / n`` of the heads."""

    def __init__(self, cfg: Wav2Vec2Config, tp_group=None):
        super().__init__()
        d = cfg.hidden_size
        self.tp_group = tp_group
        self.num_heads = cfg.num_attention_heads // _tp_size(tp_group)
        self.head_dim = d // cfg.num_attention_heads
        local = self.num_heads * self.head_dim
        self.q_proj, self.k_proj = nn.Linear(d, local), nn.Linear(d, local)
        self.v_proj, self.out_proj = nn.Linear(d, local), nn.Linear(local, d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, _ = h.shape
        hd = self.head_dim
        q = _linear(h, self.q_proj) * (hd ** -0.5)
        k, v = _linear(h, self.k_proj), _linear(h, self.v_proj)
        q, k, v = (z.reshape(b, t, self.num_heads, hd).transpose(1, 2) for z in (q, k, v))
        # the scores and the softmax at least float32 (JAX: preferred_element_type)
        scores = torch.matmul(upcast(q), upcast(k).transpose(-1, -2))
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, self.num_heads * hd)
        return _row_parallel_linear(ctx, self.out_proj, self.tp_group)


class FeedForward(nn.Module):
    """The GELU FFN; with ``tp_group`` this rank's ``1 / n`` of its hidden
    units."""

    def __init__(self, cfg: Wav2Vec2Config, tp_group=None):
        super().__init__()
        self.tp_group = tp_group
        f = cfg.intermediate_size // _tp_size(tp_group)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, f)
        self.output_dense = nn.Linear(f, cfg.hidden_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return _row_parallel_linear(F.gelu(_linear(h, self.intermediate_dense)),
                                    self.output_dense, self.tp_group)


class EncoderLayerStableLayerNorm(nn.Module):
    """Pre-LN transformer layer (``do_stable_layer_norm=True``)."""

    def __init__(self, cfg: Wav2Vec2Config, tp_group=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = Attention(cfg, tp_group)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg, tp_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(_layer_norm(x, self.layer_norm))
        return x + self.feed_forward(_layer_norm(x, self.final_layer_norm))


class Wav2Vec2Encoder(nn.Module):
    """The positional conv, the layers up to the deepest tap, and the final
    ``layer_norm`` when the last layer is tapped."""

    def __init__(self, cfg: Wav2Vec2Config, tp_group=None):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayerStableLayerNorm(cfg, tp_group)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, taps: Sequence[int]) -> Dict[int, torch.Tensor]:
        n = len(self.layers)
        x = x + self.pos_conv_embed(x)
        out = {0: x} if 0 in taps else {}
        for i in range(min(max(taps), n)):
            x = self.layers[i](x)
            if i + 1 in taps and i + 1 < n:
                out[i + 1] = x
        if max(taps) >= n:
            last = _layer_norm(x, self.layer_norm)
            out.update({t: last for t in taps if t >= n})
        return out


class Wav2Vec2Model(nn.Module):
    """Raw audio ``[B, T]`` → hidden states ``[B, frames, D]``: float32, or
    float64 for a float64 model (``dtype=torch.float64`` and ``.double()``,
    a reference for the float32 path).  With ``tp_group`` the encoder layers
    hold this rank's Megatron slices (``parallel/tp.py``)."""

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config(),
                 dtype: torch.dtype = torch.float32, tp_group=None):
        super().__init__()
        from transformer_clip_eeg_tpu_torch.parallel.tp import validate_tp

        validate_tp(config, _tp_size(tp_group))
        self.config, self.dtype = config, dtype
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Wav2Vec2Encoder(config, tp_group)

    def hidden_states(self, audio: torch.Tensor, taps: Sequence[int]) -> Dict[int, torch.Tensor]:
        """``{tap: hidden_states[tap]}`` for each tap, one pass to the
        deepest."""
        h = self.feature_projection(self.feature_extractor(audio.to(self.dtype)))
        return {t: upcast(v) for t, v in self.encoder(h, tuple(taps)).items()}

    def forward(self, audio: torch.Tensor, tap_layer: Optional[int] = None) -> torch.Tensor:
        tap = self.config.num_hidden_layers if tap_layer is None else tap_layer
        return self.hidden_states(audio, (tap,))[tap]

    def num_output_frames(self, n_samples: int) -> int:
        t = n_samples
        for k, s in zip(self.config.conv_kernel, self.config.conv_stride):
            t = (t - k) // s + 1
        return t

    def init_random(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights from ``generator``: each conv and linear weight and
        bias U(±1/sqrt(fan_in)) (torch's default), each LayerNorm's scale
        1 + 0.1 N(0, 1) and bias 0.1 N(0, 1)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    for p in (m.weight, m.bias):
                        if p is not None:
                            bound = 1.0 / math.sqrt(fan_in)
                            p.uniform_(-bound, bound, generator=generator)
                elif isinstance(m, nn.LayerNorm):
                    m.weight.normal_(generator=generator).mul_(0.1).add_(1.0)
                    m.bias.normal_(generator=generator).mul_(0.1)


# ---------------------------------------------------------------------------
# Loading: HF torch checkpoints and JAX's flax tree
# ---------------------------------------------------------------------------

_DROPPED = ("lm_head.", "masked_spec_embed")
_POS = "encoder.pos_conv_embed.conv."


def _fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``w = g * v / ||v||``, the norm over (out, in) at each kernel position
    (torch ``weight_norm(dim=2)``), in float32."""
    g, v = g.float(), v.float()
    return g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))


def convert_hf_wav2vec2(state_dict_or_model) -> Dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2Model`` / ``Wav2Vec2ForCTC`` (or its ``state_dict``) →
    this module's ``state_dict``: the ``wav2vec2.`` prefix stripped,
    ``lm_head.*`` and ``masked_spec_embed`` dropped, the positional conv's
    weight norm folded (``parametrizations.weight.original0/1`` or the older
    ``weight_g``/``weight_v``), everything in float32 on the CPU."""
    sd = state_dict_or_model
    if isinstance(sd, nn.Module):
        sd = getattr(sd, "wav2vec2", sd).state_dict()
    sd = {(k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k): v for k, v in sd.items()}
    out = {k: v.detach().float().cpu() for k, v in sd.items()
           if k.split(".")[0] in ("feature_extractor", "feature_projection", "encoder")
           and not k.startswith(_POS + "parametrizations") and not k.startswith(_POS + "weight_")}
    for g, v in (("parametrizations.weight.original0", "parametrizations.weight.original1"),
                 ("weight_g", "weight_v")):
        if _POS + g in sd:
            out[_POS + "weight"] = _fold_weight_norm(sd[_POS + g], sd[_POS + v])
    return out


def wav2vec2_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX's ``{"params": ...}`` (unrolled ``layers_{i}``) → this module's
    ``state_dict``."""
    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def dense(key, node):
        put(f"{key}.weight", np.asarray(node["kernel"]).T)
        put(f"{key}.bias", node["bias"])

    def norm(key, node):
        put(f"{key}.weight", node["scale"])
        put(f"{key}.bias", node["bias"])

    def conv(key, node):
        put(f"{key}.weight", np.asarray(node["kernel"]).transpose(2, 1, 0))
        if "bias" in node:
            put(f"{key}.bias", node["bias"])

    fe = p["feature_extractor"]
    for i in range(sum(k.startswith("conv_") for k in fe)):
        conv(f"feature_extractor.conv_layers.{i}.conv", fe[f"conv_{i}"])
        norm(f"feature_extractor.conv_layers.{i}.layer_norm", fe[f"layer_norm_{i}"])
    norm("feature_projection.layer_norm", p["feature_projection"]["layer_norm"])
    dense("feature_projection.projection", p["feature_projection"]["projection"])
    enc = p["encoder"]
    conv("encoder.pos_conv_embed.conv", enc["pos_conv_embed"]["conv"])
    norm("encoder.layer_norm", enc["layer_norm"])
    for i in range(sum(k.startswith("layers_") for k in enc)):
        layer, base = enc[f"layers_{i}"], f"encoder.layers.{i}"
        norm(f"{base}.layer_norm", layer["layer_norm"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{base}.attention.{name}", layer[name])
        norm(f"{base}.final_layer_norm", layer["final_layer_norm"])
        dense(f"{base}.feed_forward.intermediate_dense", layer["intermediate_dense"])
        dense(f"{base}.feed_forward.output_dense", layer["output_dense"])
    return out


_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a JSON
    header ``{name: {dtype, shape, data_offsets}}``, then the raw
    little-endian buffers."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, not read")
        begin, end = meta["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"]).clone()
    return out


def read_hf_directory(path: str) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """An HF checkpoint directory (what ``save_pretrained`` writes) →
    ``(config, state_dict)`` for :class:`Wav2Vec2Model`, without
    ``transformers``: ``config.json``, then ``model.safetensors`` or
    ``pytorch_model.bin``."""
    with open(os.path.join(path, "config.json")) as f:
        config = Wav2Vec2Config.from_hf(json.load(f))
    safetensors, torch_bin = (os.path.join(path, n)
                              for n in ("model.safetensors", "pytorch_model.bin"))
    if os.path.exists(safetensors):
        return config, convert_hf_wav2vec2(read_safetensors(safetensors))
    if os.path.exists(torch_bin):
        return config, convert_hf_wav2vec2(
            torch.load(torch_bin, map_location="cpu", weights_only=True))
    raise FileNotFoundError(f"{path}: no model.safetensors or pytorch_model.bin")


def load_wav2vec2(path: str, device="cuda", dtype: torch.dtype = torch.float32,
                  mesh=None) -> Wav2Vec2Model:
    """The model of an HF checkpoint directory, in eval mode on ``device``;
    under ``mesh`` on the rank's device, with the rank's Megatron slices
    when the mesh has a ``'model'`` axis."""
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device
    from transformer_clip_eeg_tpu_torch.parallel.tp import shard_wav2vec2_state_dict

    # raises before reading when the card is absent
    dev = mesh.device if mesh is not None else resolve_device(device)
    config, sd = read_hf_directory(path)
    tp_group = None if mesh is None else mesh.tp_group
    if tp_group is not None:
        sd = shard_wav2vec2_state_dict(sd, mesh.n_model, mesh.model_rank)
    with torch.device("meta"):  # no initialisation of weights about to be replaced
        model = Wav2Vec2Model(config, dtype=dtype, tp_group=tp_group)
    model.load_state_dict(sd, assign=True)
    return model.to(dev).eval()
