"""Example rich-text documents (demo banks for CLI/gradio, golden demos).

Fresh example set exercising every attribute class the framework supports
(the reference caches similar example banks in its gradio apps as de-facto
golden outputs, gradio_app.py:264-508). ``EXAMPLE_SUITES`` groups them into
the reference's four demo suites (footnote / color / style / size) and
``example_rows`` expands them into full gr.Examples input rows;
``APP_DEFAULTS`` encodes the per-app slider defaults, including the
segment-threshold deltas (gradio_app.py:187 = 0.25, gradio_app_xl.py:187 =
0.55, gradio_app_anime_xl.py:187 = 0.25).
"""

import json

APP_DEFAULTS: dict[str, dict] = {
    "SD": dict(resolution=512, segment_threshold=0.25, num_segments=9,
               inject_selfattn=0.0, inject_background=0.3,
               color_guidance_weight=0.5, seed=6, steps=41,
               guidance_weight=8.5),
    "SDXL": dict(resolution=1024, segment_threshold=0.55, num_segments=9,
                 inject_selfattn=0.0, inject_background=0.3,
                 color_guidance_weight=0.5, seed=6, steps=41,
                 guidance_weight=8.5),
    "AnimeXL": dict(resolution=1024, segment_threshold=0.25, num_segments=9,
                    inject_selfattn=0.0, inject_background=0.3,
                    color_guidance_weight=0.5, seed=6, steps=41,
                    guidance_weight=8.5),
}

EXAMPLES: dict[str, dict] = {
    "footnote-cat": {
        "ops": [
            {"insert": "A close-up 4k dslr photo of a "},
            {"attributes": {"link": "A cat wearing sunglasses and a bandana "
                                    "around its neck."},
             "insert": "cat"},
            {"insert": " riding a scooter. There are palm trees in the "
                       "background."},
        ]
    },
    "color-church": {
        "ops": [
            {"insert": "a "},
            {"attributes": {"color": "#04a704"}, "insert": "church"},
            {"insert": " with beautiful landscape in the background"},
        ]
    },
    "style-two-regions": {
        "ops": [
            {"insert": "a "},
            {"attributes": {"font": "mirza"}, "insert": "garden"},
            {"insert": " with a "},
            {"attributes": {"font": "slabo"}, "insert": "mountain"},
            {"insert": " in the distance"},
        ]
    },
    "size-reweighting": {
        "ops": [
            {"insert": "a pizza with "},
            {"attributes": {"size": "60px"}, "insert": "pineapples"},
            {"insert": ", pepperonis, and mushrooms on the top, 4k, "
                       "photorealistic"},
        ]
    },
    "strike-negation": {
        "ops": [
            {"insert": "a garden with "},
            {"attributes": {"size": "30px", "strike": True},
             "insert": "roses"},
            {"insert": " and tulips"},
        ]
    },
    "everything": {
        "ops": [
            {"insert": "a "},
            {"attributes": {"font": "ubuntu"}, "insert": "castle"},
            {"insert": " beside a "},
            {"attributes": {"color": "#0000ff",
                            "link": "A crystal-clear alpine lake with lily "
                                    "pads."},
             "insert": "lake"},
            {"insert": " under a "},
            {"attributes": {"size": "50px"}, "insert": "dramatic"},
            {"insert": " sky"},
        ]
    },
}


# suite name -> [(example key, knob overrides)] — reference demo structure:
# footnote/color/style/size suites per app (gradio_app.py:264-508)
EXAMPLE_SUITES: dict[str, list] = {
    "Footnote examples": [
        ("footnote-cat", {}),
        ("everything", {"inject_background": 0.3}),
    ],
    "Font color examples": [
        ("color-church", {"color_guidance_weight": 0.5,
                          "inject_background": 0.3}),
    ],
    "Font style examples": [
        ("style-two-regions", {}),
    ],
    "Font size examples": [
        ("size-reweighting", {}),
        ("strike-negation", {}),
    ],
}


def example_rows(model_kind: str) -> dict[str, list[list]]:
    """Expand EXAMPLE_SUITES into gr.Examples rows for ``build_app``'s input
    order: [text_input, negative_prompt, seed, steps, guidance_weight,
    color_guidance_weight, inject_selfattn, inject_background,
    segment_threshold, num_segments]."""
    d = APP_DEFAULTS[model_kind]
    out: dict[str, list[list]] = {}
    for suite, items in EXAMPLE_SUITES.items():
        rows = []
        for key, over in items:
            k = {**d, **over}
            rows.append([
                json.dumps(EXAMPLES[key]), "", k["seed"], k["steps"],
                k["guidance_weight"], k["color_guidance_weight"],
                k["inject_selfattn"], k["inject_background"],
                k["segment_threshold"], k["num_segments"],
            ])
        out[suite] = rows
    return out
