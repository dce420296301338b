"""Model configuration: the geometry dataclasses, the LLaVA-1.5-7B config and
its family entry, and `scale_down` for test-size models.

Counterparts: LMConfig (vlrlhf_tpu/models/lm/llama.py), ViTConfig
(models/vision/vit.py), ProjectorConfig / VLMConfig (models/vlm.py),
`_llava_7b`, FAMILIES["llava"], `scale_down`, ARCH_TO_FAMILY and
`resolve_family` (models/registry.py). Field
names and defaults are the same; dtypes are torch dtypes. Fields that only
training, sharding or other families read are left out.
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
    act: str = "quick_gelu"  # 'gelu' (tanh approximation) | 'quick_gelu'
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
class ProjectorConfig:
    kind: str = "mlp2x_gelu"  # the only kind ported so far
    in_dim: int = 1024
    out_dim: int = 4096


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    lm: LMConfig
    vision: ViTConfig
    projector: ProjectorConfig
    image_token_id: int
    num_image_tokens: int  # placeholder tokens per image (static)
    family: str = "llava"
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    make_config: Callable[..., VLMConfig]
    template: ChatTemplate
    processor_defaults: dict
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


FAMILIES: dict[str, ModelFamily] = {
    "llava": ModelFamily(
        name="llava",
        make_config=_llava_7b,
        template=TEMPLATES["llava"],
        processor_defaults=dict(
            num_image_tokens=576, image_token="<image>", image_token_id=32000
        ),
    ),
}


def scale_down(cfg: VLMConfig, dtype=torch.float32) -> VLMConfig:
    """Shrink a family config to test size, keeping its structure (GQA
    ratio, projector kind, class-token/pre-norm layout)."""
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
    n_img_tokens = (
        n_grid_tokens if v.drop_class_token or not v.use_class_token
        else n_grid_tokens + 1
    )
    return dataclasses.replace(
        cfg,
        lm=lm_small,
        vision=vis_small,
        projector=dataclasses.replace(cfg.projector, in_dim=16, out_dim=32),
        num_image_tokens=n_img_tokens,
        image_token_id=250,
    )


# vlrlhf_tpu/models/registry.py:272-293. Every architecture the JAX package
# imports resolves to its family; only llava is ported (FAMILIES).
ARCH_TO_FAMILY = {
    "LlavaForConditionalGeneration": "llava",
    "QWenLMHeadModel": "qwen_vl",
    "InstructBlipForConditionalGeneration": "instructblip",
    "InstructBlipForRL": "instructblip",
    "InternLMXComposer2ForCausalLM": "internlm_xc2",
}


def resolve_family(architecture: str, text_model_name: str = "") -> ModelFamily:
    """The family of an HF `architectures[0]` (LlavaNext by its text
    model's name, as vlrlhf_tpu resolves it). A family vlrlhf_tpu has and
    the port does not yet is refused by name."""
    if architecture == "LlavaNextForConditionalGeneration":
        name = ("llava_next_mistral" if "mistral" in text_model_name.lower()
                else "llava_next_vicuna")
    elif architecture in ARCH_TO_FAMILY:
        name = ARCH_TO_FAMILY[architecture]
    else:
        raise ValueError(f"architecture {architecture!r} is not a family vlrlhf_tpu supports")
    if name not in FAMILIES:
        raise ValueError(f"family {name!r} ({architecture}) is not ported to vlrlhf_torch yet "
                         "(ROADMAP.md §1 item 9)")
    return FAMILIES[name]
