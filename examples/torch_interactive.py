"""Live interactive fly-around in the terminal: WASD + arrow keys.

The closest headless analogue of the reference's experience — a continuous
poll-mode redraw loop with live keyboard input steering the fly camera
(``src/app.rs:20-80``, winit window + WASD/mouse) — rendered as 24-bit
half-block characters by present.TerminalViewer (the window stand-in).

Controls: W/A/S/D move, arrow keys look, Q quits.  Input is read raw
(termios cbreak, non-blocking) so the loop never stalls; each tick drains
pending keys into one InputEvent, exactly how the reference accumulates
key state between redraws (app.rs:52-75).

The PyTorch/CUDA port's version of examples/interactive.py: it renders on
the CUDA card unless ``--device`` names another.  Without a terminal on
stdin it runs unattended (no keys) until ``--frames N``.

usage: python examples/torch_interactive.py [config-name] [--size WxH]
       [--cols N] [--frames N] [--http PORT] [--device DEV]
"""

import argparse
import os
import select
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ash_renderer_tpu_torch.app import App, InputEvent  # noqa: E402
from ash_renderer_tpu_torch.benchmarks import ALL_CONFIGS  # noqa: E402
from ash_renderer_tpu_torch.present import TerminalViewer  # noqa: E402


def read_keys_nonblocking(fd) -> list[str]:
    """Drain pending raw input; arrow keys decode from CSI sequences."""
    keys = []
    while select.select([fd], [], [], 0)[0]:
        ch = os.read(fd, 1).decode(errors="ignore")
        if ch == "\x1b":
            rest = b""
            while select.select([fd], [], [], 0)[0] and len(rest) < 2:
                rest += os.read(fd, 1)
            seq = rest.decode(errors="ignore")
            keys.append(
                {"[A": "up", "[B": "down", "[C": "right_arrow",
                 "[D": "left_arrow"}.get(seq, "esc")
            )
        else:
            keys.append(ch.lower())
    return keys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="config3_blinn_phong")
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--cols", type=int, default=100)
    ap.add_argument("--frames", type=int, default=0,
                    help="auto-quit after N frames (0 = until Q)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="also serve the pixel-accurate live view at "
                         "http://localhost:PORT/")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU only when named)")
    args = ap.parse_args(argv)

    w, h = (int(v) for v in args.size.split("x"))
    scene, settings, cams = ALL_CONFIGS[args.config]()
    import dataclasses

    settings = dataclasses.replace(settings, width=w, height=h)
    app = App(scene, settings, camera=cams[0], speed=0.05, mouse_sens=0.05,
              device=args.device)
    term = TerminalViewer(max_cols=args.cols)
    http = None
    if args.http is not None:
        from ash_renderer_tpu_torch.present import HttpViewer

        http = HttpViewer(args.http, stats=app.renderer.stats)
        print(f"live view: http://localhost:{http.port}/", flush=True)

    def viewer(frame):
        term(frame)
        if http is not None:
            http(frame)

    interactive = sys.stdin.isatty()
    if interactive:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
    print("W/A/S/D move, arrows look, Q quits.", flush=True)
    try:
        n = 0
        while True:
            keys = read_keys_nonblocking(sys.stdin.fileno()) if interactive else []
            if "q" in keys:
                break
            ev = InputEvent(
                forward="w" in keys,
                backward="s" in keys,
                left="a" in keys,
                right="d" in keys,
                mouse_dx=(
                    ("right_arrow" in keys) - ("left_arrow" in keys)
                ) * 2.0,
                mouse_dy=(("down" in keys) - ("up" in keys)) * 2.0,
            )
            app.step(ev, on_present=viewer)
            n += 1
            if args.frames and n >= args.frames:
                break
        app.renderer.finish()
        stats = app.renderer.stats
        print(f"\n{n} frames, {stats.fps:.1f} FPS")
    finally:
        if interactive:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        if http is not None:
            http.close()


if __name__ == "__main__":
    main()
