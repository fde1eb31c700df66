"""Chat-prompt formatting (port of ``models/chat.py``; reference
utils.py:65-77 format_chat_prompt).

The reference delegates to fastchat conversation templates; here the two
template families it actually selects (vicuna for longchat models, the
model's own otherwise -- with the llama-2 system message injected) are
implemented natively.
"""

from __future__ import annotations

# the exact system message the reference sets for llama models
# (utils.py:72)
LLAMA_SYSTEM = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe. Please ensure that your "
    "responses are socially unbiased and positive in nature. If a question "
    "does not make any sense, or is not factually coherent, explain why "
    "instead of answering something not correct. If you don't know the "
    "answer to a question, please don't share false information."
)

VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions."
)


def format_chat_prompt(user_input: str, model_name: str) -> str:
    """One-turn chat prompt in the model family's template.

    llama models get the [INST]/<<SYS>> llama-2-chat template with the
    reference's system message; longchat/vicuna get the vicuna template;
    anything else passes through unchanged (the reference would fall back
    to fastchat's generic template -- a plain passthrough keeps this
    dependency-free and is what raw-completion models want).
    """
    name = model_name.lower()
    if "longchat" in name or "vicuna" in name:
        return f"{VICUNA_SYSTEM} USER: {user_input} ASSISTANT:"
    if "llama" in name:
        return (
            f"[INST] <<SYS>>\n{LLAMA_SYSTEM}\n<</SYS>>\n\n{user_input} [/INST]"
        )
    return user_input
