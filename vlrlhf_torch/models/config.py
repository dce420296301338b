"""Model configuration: the geometry dataclasses, the family configs and
entries, and `scale_down` for test-size models.

Counterparts: LMConfig (vlrlhf_tpu/models/lm/llama.py), ViTConfig
(models/vision/vit.py), QFormerConfig (models/vision/qformer.py),
ProjectorConfig / VLMConfig (models/vlm.py), `_llava_7b`,
`_llava_next_vicuna_7b`, `_llava_next_mistral_7b`, `_qwen_vl_chat`,
`_internlm_xc2_7b`, `_instructblip_vicuna_7b`, FAMILIES, `scale_down`,
ARCH_TO_FAMILY and `resolve_family` (models/registry.py). Field names and
defaults are the same; dtypes are torch dtypes. Fields that only
vlrlhf_tpu's sharding and pipelining read are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from vlrlhf_torch.data.chat_templates import TEMPLATES, ChatTemplate
from vlrlhf_torch.ops.rope import RopeConfig


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int = 0  # 0 -> hidden_size // num_heads
    rope_base: float = 10000.0
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    max_position_embeddings: int = 4096
    # QWen's use_logn_attn (ops/rope.py; an HF import of Qwen-VL reads it)
    logn_attn: bool = False
    # Mistral's sliding_window: None = full attention; set, every sequence
    # and KV cache longer than it is refused (the kernels hold no window)
    sliding_window: Optional[int] = None
    rms_eps: float = 1e-6
    qkv_bias: bool = False
    o_bias: bool = False
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # Training remat (models/lm/llama.py): vlrlhf_tpu's policies "full",
    # "attn", "dots", "mlp", "mlp1" and "acts", each keeping the per-layer
    # tensors its JAX counterpart keeps.
    remat: bool = True
    remat_policy: str = "full"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope(self) -> RopeConfig:
        return RopeConfig(
            head_dim=self.head_dim_,
            base=self.rope_base,
            scaling_type=self.rope_scaling_type,
            scaling_factor=self.rope_scaling_factor,
            max_position_embeddings=self.max_position_embeddings,
            logn_attn=self.logn_attn,
        )


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    use_class_token: bool = True
    use_pre_norm: bool = True
    use_post_norm: bool = True
    # an HF hidden_act name (models/common.py `activation`): 'quick_gelu',
    # 'gelu' (erf, what an HF import of Qwen-VL's or EVA's tower reads) or
    # 'gelu_pytorch_tanh' (jax.nn.gelu's default: the scaled-down families
    # and every config bridged from vlrlhf_tpu)
    act: str = "quick_gelu"
    # None = all layers (+post norm). -2 = penultimate layer output, no post
    # norm (LLaVA's vision_feature_layer=-2).
    feature_layer: Optional[int] = None
    drop_class_token: bool = False
    patch_bias: bool = False
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # under autograd (an unfrozen tower), each block is one checkpoint region
    remat: bool = True

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)

    @property
    def layers_run(self) -> int:
        """Layers the forward runs: feature_layer=-2 stops one short."""
        if self.feature_layer is not None and self.feature_layer != -1:
            return self.num_layers + 1 + self.feature_layer
        return self.num_layers


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    """InstructBLIP's instruction-aware query transformer (BERT geometry)."""

    vocab_size: int = 30523
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    encoder_hidden_size: int = 1408  # the tower's feature width
    num_query_tokens: int = 32
    cross_attention_frequency: int = 2
    max_position_embeddings: int = 512
    ln_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    # the feed-forward's HF hidden_act: an import reads BERT's 'gelu' (erf)
    act: str = "gelu_pytorch_tanh"


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    # 'mlp2x_gelu' (LLaVA, LLaVA-Next, InternLM-XC2), 'linear'
    # (InstructBLIP's language_projection), 'resampler' (Qwen-VL's attn_pool
    # + ln_post + proj, models/vision/resampler.py)
    kind: str = "mlp2x_gelu"
    in_dim: int = 1024
    out_dim: int = 4096
    num_queries: int = 256  # resampler only
    num_heads: int = 32  # resampler only
    # mlp2x_gelu's HF projector_hidden_act: an import reads LLaVA's 'gelu' (erf)
    act: str = "gelu_pytorch_tanh"


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    lm: LMConfig
    vision: ViTConfig
    projector: ProjectorConfig
    image_token_id: int
    num_image_tokens: int  # placeholder tokens per image (static)
    # InstructBLIP: the Q-Former between the tower and the projector
    qformer: Optional[QFormerConfig] = None
    # PLoRA (InternLM-XC2): the checkpoint's own LoRA, applied at image
    # positions only (models/common.py Linear.plora_a / plora_b)
    plora: bool = False
    family: str = "llava"
    # LLaVA-Next anyres: grid pinpoints (empty = not an anyres model)
    grid_pinpoints: tuple = ()
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)


# LoRA target patterns over the JAX-layout param paths
LM_ALL_LINEARS = (r"lm/.*attn/(wq|wk|wv|wo)/", r"lm/.*mlp/(gate|up|down)/")
QWEN_TARGETS = (r"lm/.*attn/(wq|wk|wv|wo)/", r"lm/.*mlp/(gate|up)/")


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    hf_architectures: tuple[str, ...]
    make_config: Callable[..., VLMConfig]
    template: ChatTemplate
    processor_defaults: dict
    lora_targets: tuple[str, ...]
    freeze_vision_patterns: tuple[str, ...]
    resize_mode: str = "shortest_edge_crop"
    stop_tokens: tuple[str, ...] = ()


def _llava_7b(dtype=torch.bfloat16) -> VLMConfig:
    """LLaVA-1.5-7B (vicuna LM + CLIP-L/14-336 penultimate layer)."""
    return VLMConfig(
        lm=LMConfig(
            vocab_size=32064, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32,
            max_position_embeddings=4096, rms_eps=1e-5, dtype=dtype,
        ),
        vision=ViTConfig(
            image_size=336, patch_size=14, hidden_size=1024, num_layers=24,
            num_heads=16, mlp_dim=4096, act="quick_gelu", feature_layer=-2,
            drop_class_token=True, patch_bias=False, dtype=dtype,
        ),
        projector=ProjectorConfig(kind="mlp2x_gelu", in_dim=1024, out_dim=4096),
        image_token_id=32000,
        num_image_tokens=576,
        family="llava",
    )


DEFAULT_ANYRES_PINPOINTS = (
    (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008),
)


def _llava_next_vicuna_7b(dtype=torch.bfloat16) -> VLMConfig:
    cfg = _llava_7b(dtype)
    return dataclasses.replace(
        cfg, family="llava_next_vicuna",
        grid_pinpoints=DEFAULT_ANYRES_PINPOINTS,
    )


def _llava_next_mistral_7b(dtype=torch.bfloat16) -> VLMConfig:
    return VLMConfig(
        lm=LMConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,  # Mistral GQA
            rope_base=1e6, max_position_embeddings=32768, rms_eps=1e-5,
            dtype=dtype,
        ),
        vision=ViTConfig(
            image_size=336, patch_size=14, hidden_size=1024, num_layers=24,
            num_heads=16, mlp_dim=4096, act="quick_gelu", feature_layer=-2,
            drop_class_token=True, dtype=dtype,
        ),
        projector=ProjectorConfig(kind="mlp2x_gelu", in_dim=1024, out_dim=4096),
        image_token_id=32000,
        num_image_tokens=576,
        family="llava_next_mistral",
        grid_pinpoints=DEFAULT_ANYRES_PINPOINTS,
    )


def _qwen_vl_chat(dtype=torch.bfloat16) -> VLMConfig:
    """Qwen-VL-Chat: QWen-7B LM (fused qkv bias, w2=gate/w1=up) + ViT-bigG
    448 + 256-query Resampler."""
    return VLMConfig(
        lm=LMConfig(
            vocab_size=151936, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, qkv_bias=True,
            rope_base=10000.0, rope_scaling_type="dynamic",
            max_position_embeddings=8192, rms_eps=1e-6, dtype=dtype,
        ),
        vision=ViTConfig(
            image_size=448, patch_size=14, hidden_size=1664, num_layers=48,
            num_heads=16, mlp_dim=8192, act="gelu_pytorch_tanh", use_class_token=False,
            use_pre_norm=True, use_post_norm=False, ln_eps=1e-6, dtype=dtype,
        ),
        projector=ProjectorConfig(
            kind="resampler", in_dim=1664, out_dim=4096, num_queries=256,
            num_heads=32,
        ),
        image_token_id=151859,  # <imgpad>
        num_image_tokens=256,
        family="qwen_vl",
    )


def _internlm_xc2_7b(dtype=torch.bfloat16) -> VLMConfig:
    """InternLM-XComposer2-VL-7B: InternLM2 (GQA 8 kv heads) + CLIP-L/14 run
    at 490 px (its 24x24 position grid interpolated to 35x35 in the
    forward) + 2-layer MLP projector + PLoRA at image positions."""
    return VLMConfig(
        lm=LMConfig(
            vocab_size=92544, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_base=1e6,
            max_position_embeddings=32768, rms_eps=1e-5, dtype=dtype,
        ),
        vision=ViTConfig(
            image_size=490, patch_size=14, hidden_size=1024, num_layers=24,
            num_heads=16, mlp_dim=4096, act="quick_gelu",
            feature_layer=-1,  # the last layer, before the (unused) post norm
            use_post_norm=False, drop_class_token=True, dtype=dtype,
        ),
        projector=ProjectorConfig(kind="mlp2x_gelu", in_dim=1024, out_dim=4096),
        image_token_id=92544 - 1,  # <ImageHere>, resolved from the tokenizer at load
        num_image_tokens=35 * 35,
        plora=True,
        family="internlm_xc2",
    )


def _instructblip_vicuna_7b(dtype=torch.bfloat16) -> VLMConfig:
    """InstructBLIP-Vicuna-7B: EVA ViT-g/14 @224 + Q-Former (32 queries) +
    linear projection; prefix-embedding model, 32 image tokens."""
    return VLMConfig(
        lm=LMConfig(
            vocab_size=32001, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32,
            max_position_embeddings=4096, rms_eps=1e-5, dtype=dtype,
        ),
        vision=ViTConfig(
            image_size=224, patch_size=14, hidden_size=1408, num_layers=39,
            num_heads=16, mlp_dim=6144, act="gelu_pytorch_tanh", use_pre_norm=False,
            use_post_norm=True, patch_bias=True, dtype=dtype,
        ),
        projector=ProjectorConfig(kind="linear", in_dim=768, out_dim=4096),
        qformer=QFormerConfig(
            vocab_size=30523, hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, encoder_hidden_size=1408,
            num_query_tokens=32, cross_attention_frequency=2, dtype=dtype,
        ),
        image_token_id=32000,  # added <image> token
        num_image_tokens=32,
        family="instructblip",
    )


_LLAVA_PROCESSOR = dict(num_image_tokens=576, image_token="<image>", image_token_id=32000)

FAMILIES: dict[str, ModelFamily] = {
    "llava": ModelFamily(
        name="llava",
        hf_architectures=("LlavaForConditionalGeneration", "LlavaForRL"),
        make_config=_llava_7b,
        template=TEMPLATES["llava"],
        processor_defaults=dict(_LLAVA_PROCESSOR),
        lora_targets=LM_ALL_LINEARS,
        freeze_vision_patterns=(r"^vision/", r"^projector/"),
    ),
    "llava_next_vicuna": ModelFamily(
        name="llava_next_vicuna",
        hf_architectures=("LlavaNextForConditionalGeneration",),
        make_config=_llava_next_vicuna_7b,
        template=TEMPLATES["llava_next_vicuna"],
        processor_defaults=dict(_LLAVA_PROCESSOR),
        lora_targets=LM_ALL_LINEARS,
        freeze_vision_patterns=(r"^vision/", r"^projector/"),
    ),
    "llava_next_mistral": ModelFamily(
        name="llava_next_mistral",
        hf_architectures=("LlavaNextForConditionalGeneration",),
        make_config=_llava_next_mistral_7b,
        template=TEMPLATES["llava_next_mistral"],
        processor_defaults=dict(_LLAVA_PROCESSOR),
        lora_targets=LM_ALL_LINEARS,
        freeze_vision_patterns=(r"^vision/", r"^projector/"),
    ),
    "qwen_vl": ModelFamily(
        name="qwen_vl",
        hf_architectures=("QWenLMHeadModel", "QwenVLForRL"),
        make_config=_qwen_vl_chat,
        template=TEMPLATES["qwen_vl"],
        processor_defaults=dict(
            num_image_tokens=256, image_token="<image>", image_token_id=151859,
            image_start_id=151857, image_end_id=151858, image_pad_id=151859,
            add_bos=False,  # QWen has no BOS
        ),
        # c_attn -> wq/wk/wv, attn.c_proj -> wo, w1 -> up, w2 -> gate; the
        # MLP's c_proj (down) is not a target
        lora_targets=QWEN_TARGETS,
        # the resampler (attn_pool) stays trainable
        freeze_vision_patterns=(r"^vision/", r"^projector/(ln_post|proj)/"),
        resize_mode="squash",
        stop_tokens=("<|im_end|>", "<|im_start|>"),
    ),
    "internlm_xc2": ModelFamily(
        name="internlm_xc2",
        hf_architectures=("InternLMXComposer2ForCausalLM",),
        make_config=_internlm_xc2_7b,
        template=TEMPLATES["internlm_xc2"],
        processor_defaults=dict(
            num_image_tokens=35 * 35, image_token="<ImageHere>",
            image_token_id=92543,
        ),
        lora_targets=LM_ALL_LINEARS,
        freeze_vision_patterns=(r"^vision/", r"^projector/"),
        resize_mode="squash",
        stop_tokens=("[UNUSED_TOKEN_145]",),
    ),
    "instructblip": ModelFamily(
        name="instructblip",
        hf_architectures=("InstructBlipForConditionalGeneration", "InstructBlipForRL"),
        make_config=_instructblip_vicuna_7b,
        template=TEMPLATES["instructblip"],
        processor_defaults=dict(
            num_image_tokens=32, image_token="<image>", image_token_id=32000,
            prefix_image_tokens=True,
        ),
        lora_targets=LM_ALL_LINEARS,
        freeze_vision_patterns=(r"^vision/", r"^projector/", r"^qformer/"),
    ),
}


def scale_down(cfg: VLMConfig, dtype=torch.float32) -> VLMConfig:
    """Shrink a family config to test size, keeping its structure (GQA
    ratio, projector kind, Q-Former, PLoRA, class-token/pre-norm layout)."""
    lm = cfg.lm
    kv_ratio = max(lm.num_heads // lm.num_kv_heads, 1)
    lm_small = dataclasses.replace(
        lm, vocab_size=256, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4, num_kv_heads=max(4 // kv_ratio, 1),
        head_dim=8, dtype=dtype, remat=False,
    )
    v = cfg.vision
    vis_small = dataclasses.replace(
        v, image_size=16, patch_size=4, hidden_size=16, num_layers=2,
        num_heads=2, mlp_dim=32, dtype=dtype,
    )
    n_grid_tokens = (16 // 4) ** 2
    qf = None
    proj = dataclasses.replace(cfg.projector, in_dim=16, out_dim=32)
    if cfg.projector.kind == "resampler":
        proj = dataclasses.replace(proj, num_queries=4, num_heads=2)
        n_img_tokens = 4
    elif cfg.qformer is not None:
        qf = dataclasses.replace(
            cfg.qformer, vocab_size=64, hidden_size=16, num_layers=2,
            num_heads=2, intermediate_size=32, encoder_hidden_size=16,
            num_query_tokens=4, dtype=dtype,
        )
        n_img_tokens = 4
    else:
        n_img_tokens = (
            n_grid_tokens if v.drop_class_token or not v.use_class_token
            else n_grid_tokens + 1
        )
    return dataclasses.replace(
        cfg,
        lm=lm_small,
        vision=vis_small,
        projector=proj,
        qformer=qf,
        num_image_tokens=n_img_tokens,
        image_token_id=250,
    )


# vlrlhf_tpu/models/registry.py: every architecture the JAX package imports
# resolves to its family.
ARCH_TO_FAMILY = {
    "LlavaForConditionalGeneration": "llava",
    "QWenLMHeadModel": "qwen_vl",
    "InstructBlipForConditionalGeneration": "instructblip",
    "InstructBlipForRL": "instructblip",
    "InternLMXComposer2ForCausalLM": "internlm_xc2",
}


def resolve_family(architecture: str, text_model_name: str = "") -> ModelFamily:
    """The family of an HF `architectures[0]` (LlavaNext by its text
    model's name, as vlrlhf_tpu resolves it); any other architecture is
    refused by name."""
    if architecture == "LlavaNextForConditionalGeneration":
        name = ("llava_next_mistral" if "mistral" in text_model_name.lower()
                else "llava_next_vicuna")
    elif architecture in ARCH_TO_FAMILY:
        name = ARCH_TO_FAMILY[architecture]
    else:
        raise ValueError(f"architecture {architecture!r} is not a family vlrlhf_tpu supports")
    return FAMILIES[name]
