"""Train the colour fixture with the port (``rich_text_to_image_tpu_torch.
training.color_fixture``): a tiny VAE and UNet on synthetic coloured
squares, written as ``unet_params.npz``, ``vae_params.npz`` and
``fixture_meta.json`` into ``--out`` (``results/color_fixture_torch/`` by
default), readable by both packages' ``load_color_fixture``.

    python scripts/port_train_color_fixture.py            # on the card
    python scripts/port_train_color_fixture.py --device cpu \\
        --vae_steps 3 --unet_steps 3 --batch 4 --out /tmp/fixture
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rich_text_to_image_tpu_torch.training import color_fixture  # noqa: E402

if __name__ == "__main__":
    color_fixture.main()
