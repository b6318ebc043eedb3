"""Colour guidance on a trained fixture with the port
(``rich_text_to_image_tpu_torch.evaluation.color_fixture_eval``): the
gradient cosines of exact against pooled guidance and the colour benchmark
in the exact, ``gds2`` and ``bf16`` configurations, written as
``summary_<name>.json``, ``grad_cosine.jsonl`` and ``verdict.json`` into
``--out`` (``results/color_fixture_eval_torch/`` by default).

    python scripts/port_eval_color_fixture.py             # on the card
    python scripts/port_eval_color_fixture.py \\
        --fixture_dir results/color_fixture_torch
    python scripts/port_eval_color_fixture.py --device cpu --steps 3 \\
        --limit 1 --num_seeds 1 --out /tmp/fixture_eval
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rich_text_to_image_tpu_torch.evaluation import (  # noqa: E402
    color_fixture_eval)

if __name__ == "__main__":
    color_fixture_eval.main()
