"""The rich-text front end of the plain reference: the byte-level CLIP
tokenizer the benchmark serves with (every byte a unit, the last of a word
closed by ``</w>``, no merges), the Quill Delta parse, the region prompts
and span token ids (the paper's Algorithm 1), and the colour-guidance
inputs. Written from the reference implementation's
``utils/richtext_utils.py`` rules; numpy and the standard library only.
"""

from __future__ import annotations

import re

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
MAX_LEN = 77

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE)
_WS = re.compile(r"\s+")

COLORS = {
    "brown": [165, 42, 42], "red": [255, 0, 0], "pink": [253, 108, 158],
    "orange": [255, 165, 0], "yellow": [255, 255, 0],
    "purple": [128, 0, 128], "green": [0, 128, 0], "blue": [0, 0, 255],
    "white": [255, 255, 255], "gray": [128, 128, 128], "black": [0, 0, 0],
}

FONT2STYLE = {
    "mirza": "Claud Monet, impressionism, oil on canvas",
    "roboto": "Ukiyoe",
    "cursive": "Cyber Punk, futuristic, blade runner, william gibson, "
               "trending on artstation hq",
    "sofia": "Pop Art, masterpiece, andy warhol",
    "slabo": "Vincent Van Gogh",
    "inconsolata": "Pixel Art, 8 bits, 16 bits",
    "ubuntu": "Rembrandt",
    "Monoton": "neon art, colorful light, highly details, octane render",
    "Akronim": "Abstract Cubism, Pablo Picasso",
}


def _byte_units() -> tuple[list[int], list[str]]:
    """GPT-2/CLIP's reversible byte -> printable unit map, as (bytes,
    units) in table order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    rest = [b for b in range(256) if b not in bs]
    units = [chr(b) for b in bs] + [chr(256 + n) for n in range(len(rest))]
    return bs + rest, units


class ByteTokenizer:
    """CLIP's byte-level tokenization with an empty merge table."""

    def __init__(self):
        bs, units = _byte_units()
        self.byte_unit = dict(zip(bs, units))
        vocab = {u: i for i, u in enumerate(units)}
        for u in units:
            vocab[u + "</w>"] = len(vocab)
        vocab[BOS] = len(vocab)
        vocab[EOS] = len(vocab)
        self.vocab = vocab

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in _PAT.findall(_WS.sub(" ", text).strip().lower()):
            if word in (BOS, EOS):
                out.append(word)
                continue
            units = [self.byte_unit[b] for b in word.encode("utf-8")]
            units[-1] += "</w>"
            out.extend(units)
        return out

    def ids(self, text: str) -> np.ndarray:
        """[77] int64: BOS, the units' ids, EOS, padded with EOS."""
        body = [self.vocab[t] for t in self.tokenize(text)][:MAX_LEN - 2]
        row = [self.vocab[BOS], *body, self.vocab[EOS]]
        row += [self.vocab[EOS]] * (MAX_LEN - len(row))
        return np.asarray(row, np.int64)


def nearest_color(rgb: np.ndarray) -> str:
    names = list(COLORS)
    table = np.asarray([COLORS[n] for n in names], np.float32) / 255.0
    return names[int(np.argmin(np.linalg.norm(table - rgb[None], axis=1)))]


def rich_inputs(tok: ByteTokenizer, delta: dict, color_weight: float) -> dict:
    """Everything the two passes take from the rich text: the base prompt,
    the region prompts (base last) with their 1-based token ids, the
    colour spans' token ids and target colours, and the font-size weights
    (None without a size span)."""
    base, styles, notes, colors, sizes = "", [], [], [], []
    prev_style = None
    for span in delta["ops"]:
        text = span["insert"].rstrip("\n")
        base += text
        if text == " " or not span.get("attributes"):
            continue
        a = span["attributes"]
        if "font" in a:
            style = FONT2STYLE[a["font"]]
            if prev_style == style:
                head = styles[-1].split("in the style of")[0]
                styles[-1] = f"{head} {text} in the style of {style}"
            else:
                styles.append(f"{text} in the style of {style}")
            prev_style = style
        else:
            prev_style = None
        if "link" in a:
            notes.append((a["link"], text))
        size = 1.0
        if "size" in a:
            size = float(a["size"][:-2]) / 3.0 * (-1 if "strike" in a else 1)
        if "color" in a:
            h = a["color"].lstrip("#")
            rgb = np.asarray([int(h[i:i + 2], 16) for i in (0, 2, 4)],
                             np.float32) / 255.0
            colors.append((text, rgb))
        if size != 1.0:
            sizes.append((text, size))
    base_tokens = tok.tokenize(base)

    def ids_of(text):  # 1-based first occurrence in the base prompt
        return [base_tokens.index(t) + 1 for t in tok.tokenize(text)]

    def rest(lists):
        taken = {i for ids in lists for i in ids}
        return [i for i in range(1, len(base_tokens) + 1) if i not in taken]

    prompts, ids = [], []
    for s in styles:
        prompts.append(s)
        ids.append(ids_of(s.split("in the style of")[0]))
    for note, target in notes:
        prompts.append(note)
        ids.append(ids_of(target))
    for text, rgb in colors:
        prompts.append(f"{nearest_color(rgb)} {text}")
        ids.append(ids_of(text))
    prompts.append(base)
    ids.append(rest(ids))
    color_ids = [ids_of(t) for t, _ in colors]
    word_pos, font = [], []
    for text, size in sizes:
        for i in ids_of(text):
            word_pos.append(i)
            font.append(size)
    return dict(base=base, region_prompts=prompts,
                region_ids=[np.asarray(i, np.int64) for i in ids],
                color_ids=[np.asarray(i, np.int64) for i in color_ids],
                color_rgb=[rgb for _, rgb in colors],
                color_weight=float(color_weight),
                word_pos=np.asarray(word_pos, np.int64) if word_pos else None,
                font_size=np.asarray(font, np.float32) if font else None)
