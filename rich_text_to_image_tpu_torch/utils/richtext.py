"""Rich-text JSON front end: Quill Delta → generation controls.

Pure host-side functions turning the rich-text editor's JSON into
  * a base (plain) prompt,
  * per-attribute span lists (style / footnote / color / size),
  * region prompts + 1-based token-id lists per span ("Algorithm 1"),
  * font-size attention-reweighting spec,
  * gradient color-guidance spec.

Behavioral parity with the reference front end
(utils/richtext_utils.py:74-234), including its quirks:
  * spans whose text is exactly one space are skipped;
  * adjacent spans with the same font style are merged into one region;
  * color spans are never merged (the reference's ``prev_color_rgb`` is never
    reassigned, so its merge branch is dead code — richtext_utils.py:125);
  * ``strike`` without ``size`` leaves the weight at 1 (no reweighting);
  * token ids use ``base_tokens.index(tok) + 1`` — first occurrence, 1-based
    (offset for the BOS token the text encoder prepends).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from .colors import find_nearest_color, hex_to_rgb

# Font-family → artistic style (reference: utils/richtext_utils.py:59-71).
FONT2STYLE: dict[str, str] = {
    "mirza": "Claud Monet, impressionism, oil on canvas",
    "roboto": "Ukiyoe",
    "cursive": "Cyber Punk, futuristic, blade runner, william gibson, trending on artstation hq",
    "sofia": "Pop Art, masterpiece, andy warhol",
    "slabo": "Vincent Van Gogh",
    "inconsolata": "Pixel Art, 8 bits, 16 bits",
    "ubuntu": "Rembrandt",
    "Monoton": "neon art, colorful light, highly details, octane render",
    "Akronim": "Abstract Cubism, Pablo Picasso",
}


def font2style(font: str) -> str:
    return FONT2STYLE[font]


@dataclasses.dataclass
class ParsedRichText:
    """Span attributes extracted from a Quill Delta document."""

    base_text_prompt: str
    style_text_prompts: list[str]
    footnote_text_prompts: list[str]
    footnote_target_tokens: list[str]
    color_text_prompts: list[str]
    color_names: list[str]
    color_rgbs: list[np.ndarray]  # each (3,) float32 in [0, 1]
    size_text_prompts_and_sizes: list[tuple[str, float]]
    use_grad_guidance: bool


def parse_json(delta: dict[str, Any]) -> ParsedRichText:
    """Parse a Quill Delta ``{"ops": [...]}`` document into span attributes.

    Reference: utils/richtext_utils.py:74-136.
    """
    base_text_prompt = ""
    style_text_prompts: list[str] = []
    footnote_text_prompts: list[str] = []
    footnote_target_tokens: list[str] = []
    color_text_prompts: list[str] = []
    color_rgbs: list[np.ndarray] = []
    color_names: list[str] = []
    size_text_prompts_and_sizes: list[tuple[str, float]] = []

    prev_style = None
    use_grad_guidance = False
    for span in delta["ops"]:
        text_prompt = span["insert"].rstrip("\n")
        base_text_prompt += text_prompt
        if text_prompt == " ":
            continue
        attrs = span.get("attributes")
        if not attrs:
            continue

        if "font" in attrs:
            style = font2style(attrs["font"])
            if prev_style == style:
                prev_text_prompt = style_text_prompts[-1].split("in the style of")[0]
                style_text_prompts[-1] = (
                    prev_text_prompt + " " + text_prompt + f" in the style of {style}"
                )
            else:
                style_text_prompts.append(text_prompt + f" in the style of {style}")
            prev_style = style
        else:
            prev_style = None

        if "link" in attrs:
            footnote_text_prompts.append(attrs["link"])
            footnote_target_tokens.append(text_prompt)

        font_size = 1.0
        if "size" in attrs and "strike" not in attrs:
            font_size = float(attrs["size"][:-2]) / 3.0
        elif "size" in attrs and "strike" in attrs:
            font_size = -float(attrs["size"][:-2]) / 3.0
        # NB: "strike" without "size" intentionally leaves font_size == 1
        # (reference elif-chain, richtext_utils.py:114-120).

        if "color" in attrs:
            use_grad_guidance = True
            rgb = hex_to_rgb(attrs["color"])
            # Color spans are never merged — see module docstring.
            color_rgbs.append(rgb)
            color_names.append(find_nearest_color(rgb))
            color_text_prompts.append(text_prompt)

        if font_size != 1.0:
            size_text_prompts_and_sizes.append((text_prompt, font_size))

    return ParsedRichText(
        base_text_prompt=base_text_prompt,
        style_text_prompts=style_text_prompts,
        footnote_text_prompts=footnote_text_prompts,
        footnote_target_tokens=footnote_target_tokens,
        color_text_prompts=color_text_prompts,
        color_names=color_names,
        color_rgbs=color_rgbs,
        size_text_prompts_and_sizes=size_text_prompts_and_sizes,
        use_grad_guidance=use_grad_guidance,
    )


def _span_token_ids(base_tokens: Sequence[str], span_tokens: Sequence[str]) -> list[int]:
    """1-based first-occurrence ids of ``span_tokens`` within ``base_tokens``.

    Reference: utils/richtext_utils.py:151-155 (``base_tokens.index(tok)+1``).
    Raises ValueError if a span token is absent from the base prompt, exactly
    like ``list.index`` in the reference.
    """
    return [list(base_tokens).index(tok) + 1 for tok in span_tokens]


def get_region_diffusion_input(
    tokenize,
    parsed: ParsedRichText,
) -> tuple[list[str], list[np.ndarray], list[str]]:
    """Build region prompts + per-region 1-based token-id arrays.

    "Algorithm 1" of the paper (reference: utils/richtext_utils.py:139-185).
    ``tokenize`` is a sub-word tokenizer callable: str -> list of token
    strings (the ``tokenizer._tokenize`` equivalent). Returns
    (region_text_prompts, region_target_token_ids, base_tokens); the final
    region is the base prompt covering all unattributed tokens.
    """
    region_text_prompts: list[str] = []
    region_target_token_ids: list[list[int]] = []
    base_tokens = list(tokenize(parsed.base_text_prompt))

    # Style spans → "<span> in the style of <style>".
    for text_prompt in parsed.style_text_prompts:
        region_text_prompts.append(text_prompt)
        span = text_prompt.split("in the style of")[0]
        region_target_token_ids.append(_span_token_ids(base_tokens, tokenize(span)))

    # Footnote spans → footnote text as the region prompt.
    for footnote_text, target_text in zip(
        parsed.footnote_text_prompts, parsed.footnote_target_tokens
    ):
        region_text_prompts.append(footnote_text)
        region_target_token_ids.append(
            _span_token_ids(base_tokens, tokenize(target_text))
        )

    # Color spans → "<nearest-color> <span>".
    for color_text, color_name in zip(parsed.color_text_prompts, parsed.color_names):
        region_text_prompts.append(color_name + " " + color_text)
        region_target_token_ids.append(
            _span_token_ids(base_tokens, tokenize(color_text))
        )

    # Leftover tokens → the base prompt region.
    region_text_prompts.append(parsed.base_text_prompt)
    attributed = {tid for ids in region_target_token_ids for tid in ids}
    rest = [tid for tid in range(1, len(base_tokens) + 1) if tid not in attributed]
    region_target_token_ids.append(rest)

    return (
        region_text_prompts,
        [np.asarray(ids, dtype=np.int32) for ids in region_target_token_ids],
        base_tokens,
    )


def get_attention_control_input(
    tokenize, base_tokens: Sequence[str], parsed: ParsedRichText
) -> dict[str, Any]:
    """Font-size spans → (word_pos, font_size) reweighting arrays.

    Reference: utils/richtext_utils.py:188-209. Returns a text_format_dict
    with ``word_pos`` (int32, 1-based) and ``font_size`` (float32) arrays, or
    None values when no size spans exist.
    """
    word_pos: list[int] = []
    font_sizes: list[float] = []
    for text_prompt, font_size in parsed.size_text_prompts_and_sizes:
        for tid in _span_token_ids(base_tokens, tokenize(text_prompt)):
            word_pos.append(tid)
            font_sizes.append(font_size)
    if word_pos:
        return {
            "word_pos": np.asarray(word_pos, dtype=np.int32),
            "font_size": np.asarray(font_sizes, dtype=np.float32),
        }
    return {"word_pos": None, "font_size": None}


def get_gradient_guidance_input(
    tokenize,
    base_tokens: Sequence[str],
    parsed: ParsedRichText,
    text_format_dict: dict[str, Any],
    guidance_start_step: int = 999,
    color_guidance_weight: float = 1.0,
) -> tuple[dict[str, Any], list[np.ndarray]]:
    """Color spans → per-span token ids + guidance config.

    Reference: utils/richtext_utils.py:212-234. The final entry of
    ``color_target_token_ids`` is the complement ("rest") id list.
    """
    color_target_token_ids: list[list[int]] = []
    for text_prompt in parsed.color_text_prompts:
        color_target_token_ids.append(
            _span_token_ids(base_tokens, tokenize(text_prompt))
        )
    attributed = {tid for ids in color_target_token_ids for tid in ids}
    rest = [tid for tid in range(1, len(base_tokens) + 1) if tid not in attributed]
    color_target_token_ids.append(rest)

    text_format_dict = dict(text_format_dict)
    text_format_dict["target_RGB"] = parsed.color_rgbs
    text_format_dict["guidance_start_step"] = guidance_start_step
    text_format_dict["color_guidance_weight"] = color_guidance_weight
    return text_format_dict, [
        np.asarray(ids, dtype=np.int32) for ids in color_target_token_ids
    ]
