"""Chat templates of every family (copy of vlrlhf_tpu/data/chat_templates.py,
string-for-string identical so tokenization matches). qwen_vl's ChatML is
built token by token (data/processor.py, `style="chatml"`); internlm_xc2
carries its hard-coded system preamble.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    user_begin: str = ""
    user_end: str = ""
    assistant_begin: str = ""
    assistant_end: str = ""
    system_begin: Optional[str] = None
    system_end: Optional[str] = None
    image_placeholder: str = "<image>\n"
    # Raw text prepended to every conversation (vicuna preamble / XC2 system).
    preamble: str = ""
    # 'incremental' = retokenize-growing-string labeling; 'chatml' = token-
    # level ChatML building (Qwen).
    style: str = "incremental"
    # ChatML only:
    system_message: str = "You are a helpful assistant."


VICUNA_PREAMBLE = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions. "
)

XC2_SYSTEM = (
    "<s>[UNUSED_TOKEN_146]system\n"
    "You are an AI assistant whose name is InternLM-XComposer (浦语·灵笔).\n"
    "-InternLM-XComposer (浦语·灵笔) is a multi-modality conversational language "
    "model that is developed by Shanghai AI Laboratory (上海人工智能实验室). "
    "It is designed to be helpful, honest, and harmless.\n"
    "-InternLM-XComposer (浦语·灵笔) can understand and communicate fluently in "
    "the language chosen by the user such as English and 中文.\n"
    "-InternLM-XComposer (浦语·灵笔) is capable of comprehending and articulating "
    "responses effectively based on the provided image.[UNUSED_TOKEN_145]\n"
)

TEMPLATES: dict[str, ChatTemplate] = {
    "llava": ChatTemplate(
        user_begin="USER: ",
        user_end="",
        assistant_begin="ASSISTANT: ",
        assistant_end="",
        image_placeholder="<image>\n",
    ),
    "llava_next_mistral": ChatTemplate(
        user_begin="[INST] ",
        user_end=" [/INST]",
        assistant_begin="",
        assistant_end="",
        image_placeholder="<image>\n",
    ),
    "llava_next_vicuna": ChatTemplate(
        user_begin="USER: ",
        user_end="",
        assistant_begin="ASSISTANT: ",
        assistant_end="",
        image_placeholder="<image>\n",
        preamble=VICUNA_PREAMBLE,
    ),
    "internlm_xc2": ChatTemplate(
        system_begin="<s>[UNUSED_TOKEN_146]system\n",
        system_end="[UNUSED_TOKEN_145]\n",
        user_begin="[UNUSED_TOKEN_146]user\n",
        user_end="[UNUSED_TOKEN_145]\n",
        assistant_begin="[UNUSED_TOKEN_146]assistant\n",
        assistant_end="[UNUSED_TOKEN_145]\n",
        image_placeholder="<ImageHere>",
        preamble=XC2_SYSTEM,
    ),
    "instructblip": ChatTemplate(
        user_begin="",
        user_end="",
        assistant_begin="",
        assistant_end="",
        image_placeholder="",
    ),
    "qwen_vl": ChatTemplate(
        style="chatml",
        image_placeholder="<image>",
    ),
}
