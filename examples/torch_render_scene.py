#!/usr/bin/env python
"""Render a benchmark scene (or your own OBJ/glTF) to PNG frames with the
PyTorch/CUDA port, on the CUDA card unless ``--device`` names another.

  python examples/torch_render_scene.py config3_blinn_phong --out /tmp/frames
  python examples/torch_render_scene.py path/to/model.gltf --frames 16
  python examples/torch_render_scene.py reference --size 320x240 --device cpu
"""

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ash_renderer_tpu_torch.app import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:] or ["config3_blinn_phong", "--out", "/tmp/frames"])
