"""Chat templates of the ported families (copy of
vlrlhf_tpu/data/chat_templates.py: llava, llava_next_mistral,
llava_next_vicuna and instructblip; string-for-string identical so
tokenization matches).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    user_begin: str = ""
    user_end: str = ""
    assistant_begin: str = ""
    assistant_end: str = ""
    image_placeholder: str = "<image>\n"
    # Raw text prepended to every conversation.
    preamble: str = ""


VICUNA_PREAMBLE = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions. "
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
    "instructblip": ChatTemplate(
        user_begin="",
        user_end="",
        assistant_begin="",
        assistant_end="",
        image_placeholder="",
    ),
}
