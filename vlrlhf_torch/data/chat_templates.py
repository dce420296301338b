"""Chat templates serving needs (copy of vlrlhf_tpu/data/chat_templates.py,
LLaVA-1.5 entry only; string-for-string identical so tokenization matches).
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


TEMPLATES: dict[str, ChatTemplate] = {
    "llava": ChatTemplate(
        user_begin="USER: ",
        user_end="",
        assistant_begin="ASSISTANT: ",
        assistant_end="",
        image_placeholder="<image>\n",
    ),
}
