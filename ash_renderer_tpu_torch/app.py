"""App shell: the frame loop (reference ``src/app.rs`` + ``main.rs``),
the port's copy of ``ash_renderer_tpu/app.py``.

The reference runs a winit event loop in poll mode: RedrawRequested ->
update_camera -> draw_frame -> request_redraw forever (``app.rs:76-80``,
``main.rs:19``), with WASD/mouse input mutating a CameraController
(``app.rs:20-75``).  Headless hosts have no window, so the shell drives the
same loop from scripted or programmatic input and presents through the
frame ring to PNG and live-view sinks.

Every entry point renders on the CUDA card unless the caller names another
device (``device="cpu"``, ``--device cpu``); without a card they raise and
never carry on on the CPU.

    python -m ash_renderer_tpu_torch.app config4_terrain --out frames
    python -m ash_renderer_tpu_torch.app reference --size 64x48 --device cpu
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, Optional

import torch

from .camera import Camera, CameraController, orbit_path
from .config import RendererSettings
from .present import FrameCollector, write_png
from .renderer import Renderer
from .scene import Scene


def require_device(device) -> torch.device:
    """``device`` as a torch device; raises if it is a CUDA device and this
    process sees no CUDA card (the app never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: the app renders on the card; pass "
            "device='cpu' (--device cpu) to render on the CPU"
        )
    return dev


@dataclasses.dataclass
class InputEvent:
    """One tick of input: key states + mouse deltas (app.rs:52-75 analogue)."""

    forward: bool = False
    backward: bool = False
    left: bool = False
    right: bool = False
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0


class App:
    """Owns renderer + camera + controller; runs the frame loop on
    ``device`` (the CUDA card by default)."""

    def __init__(
        self,
        scene: Scene,
        settings: Optional[RendererSettings] = None,
        camera: Optional[Camera] = None,
        speed: float = 0.01,
        mouse_sens: float = 0.01,
        warmup: bool = True,
        *,
        device="cuda",
    ):
        self.renderer = Renderer(scene, settings, device=require_device(device))
        if warmup and self.renderer.device.type == "cuda":
            # build and load the route's kernel libraries and run one frame
            # before the loop starts.  On the card only, as the reference
            # warms up on the TPU only: on the CPU there is nothing to build
            # and the extra frame costs more than it hides.  warmup=False
            # for callers that render exactly one frame anyway.
            self.renderer.warmup()
        self.camera = camera or Camera()
        self.controller = CameraController(speed=speed, mouse_sens=mouse_sens)
        # the "window" extent: mutated by resize events (request_resize);
        # draw_frame notices the mismatch and self-recovers, like the
        # reference's OUT_OF_DATE swapchain path (renderer.rs:416-428)
        st = self.renderer.settings
        self.extent = (st.width, st.height)

    def request_resize(self, width: int, height: int):
        """Window-resize event (winit WindowEvent::Resized analogue): only
        records the new extent; the running loop recovers by itself on the
        next draw_frame."""
        self.extent = (int(width), int(height))

    def step(self, event: Optional[InputEvent] = None, on_present=None):
        """One loop iteration: apply input, update camera, draw."""
        if event is not None:
            c = self.controller
            c.forward_pressed = event.forward
            c.backward_pressed = event.backward
            c.left_pressed = event.left
            c.right_pressed = event.right
            c.process_mouse(event.mouse_dx, event.mouse_dy)
        self.controller.update_camera(self.camera)
        return self.renderer.draw_frame(
            self.camera, on_present=on_present, extent=self.extent
        )

    def run(
        self,
        n_frames: int,
        events: Optional[Iterable[InputEvent]] = None,
        on_present: Optional[Callable] = None,
    ):
        """Run the continuous loop for n_frames (poll-mode analogue)."""
        events = iter(events) if events is not None else iter(())
        for _ in range(n_frames):
            self.step(next(events, None), on_present)
        self.renderer.finish()
        return self.renderer.stats

    def run_path(self, cameras: list[Camera], on_present=None):
        """Render a scripted camera path (benchmark/flythrough mode)."""
        for cam in cameras:
            self.renderer.draw_frame(cam, on_present=on_present)
        self.renderer.finish()
        return self.renderer.stats


def render_to_images(
    scene: Scene,
    settings: RendererSettings,
    cameras: list[Camera],
    out_dir: str,
    prefix: str = "frame",
    extra_present: Optional[Callable] = None,
    device="cuda",
) -> list[str]:
    """Offline render of a camera path to numbered PNGs.  extra_present:
    additional per-frame sink (e.g. a live HttpViewer)."""
    app = App(scene, settings, device=device)
    os.makedirs(out_dir, exist_ok=True)
    collector = FrameCollector()

    def present(frame):
        collector(frame)
        if extra_present is not None:
            extra_present(frame)

    app.run_path(cameras, on_present=present)
    paths = []
    for i, frame in enumerate(collector.frames):
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        write_png(p, frame)
        paths.append(p)
    return paths


def main(argv=None):
    """CLI: render a benchmark config or an asset file to PNGs.

    usage: python -m ash_renderer_tpu_torch.app [config-name|file.obj|file.gltf]
           [--frames N] [--size WxH] [--out DIR] [--http PORT] [--device DEV]
    """
    import argparse

    from . import benchmarks

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("source", nargs="?", default="reference")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--size", default=None, help="WxH override")
    ap.add_argument("--out", default="./frames")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve a pixel-accurate live view at "
                         "http://localhost:PORT/ while rendering")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda; the "
                         "CPU only when named)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    if args.source in benchmarks.ALL_CONFIGS:
        scene, settings, cameras = benchmarks.ALL_CONFIGS[args.source]()
    elif args.source.endswith((".gltf", ".glb")):
        from .models import load_gltf

        scene = load_gltf(args.source)
        settings = RendererSettings()
        cameras = orbit_path(max(args.frames, 1), radius=4.0)
    elif args.source.endswith(".obj"):
        from . import mathx
        from .models import load_obj
        from .scene import SceneObject

        scene = Scene()
        scene.add_object(
            SceneObject(
                mesh=scene.add_mesh(load_obj(args.source)),
                model=mathx.translation([0, 0, 3]),
            )
        )
        settings = RendererSettings()
        cameras = [Camera()]
    else:
        raise SystemExit(f"unknown source {args.source!r}")

    if args.size:
        w, h = (int(x) for x in args.size.split("x"))
        settings = dataclasses.replace(settings, width=w, height=h)
    if args.frames > len(cameras):
        cameras = cameras * (args.frames // len(cameras) + 1)
    cameras = cameras[: args.frames]

    viewer = None
    if args.http is not None:
        from .present import HttpViewer

        viewer = HttpViewer(args.http)
        print(f"live view: http://localhost:{viewer.port}/")
    t0 = time.time()
    try:
        paths = render_to_images(
            scene, settings, cameras, args.out, extra_present=viewer,
            device=device,
        )
    finally:
        if viewer is not None:
            viewer.close()
    dt = time.time() - t0
    print(
        f"rendered {len(paths)} frame(s) at {settings.width}x{settings.height}"
        f" in {dt:.2f}s -> {args.out}"
    )
    return paths


if __name__ == "__main__":
    main()
