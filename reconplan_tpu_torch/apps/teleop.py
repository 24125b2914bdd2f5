"""Keyboard teleop CLI — rebuild of ``UR10_RTDE/examples/teleop_keyboard.py``.

Port of ``reconplan_tpu.apps.teleop``; the robot and the roadmap live on
``device`` (``--device``; default: the card).

Same control scheme as the reference (w/s = ±X, a/d = ±Y, i/j = ±Z,
q = quit, step 1 mm per tick at the servo rate) driving either:

  * the RTDE servo path (``--mode rtde``; SimRTDE by default, the real arm
    with ``--hardware``) through the anchor-tracking
    :class:`reconplan_tpu_torch.io.drivers.Teleop` state machine — the
    reference's exact architecture; or
  * the GRR resolution (``--mode grr``): each tick solves the moved target
    through ``RedundancyResolution.teleop_solve``, the joint-continuous
    teleoperation the roadmap exists for (reference ``klampt_vis.py``'s
    idle-tick teleop without the Klampt GUI).

The reference used ``pynput`` (an X11 dependency); this reads raw
terminal input (termios cbreak, stdlib-only) so it runs over ssh on a
display-less host. Without a TTY it falls back to line input
("wwassdij..." then enter). pygame (``--joystick``) is imported only when
a joystick is opened.
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np

# the repo's committed roadmaps
GRAPH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "graph",
)

KEYMAP = {  # teleop_keyboard.py:97-107
    "w": (0, +1), "s": (0, -1),
    "a": (1, +1), "d": (1, -1),
    "i": (2, +1), "j": (2, -1),
}


class _RawKeys:
    """cbreak-mode non-blocking key reader (stdlib termios; no pynput/X11)."""

    def __init__(self):
        self._tty = sys.stdin.isatty()
        if self._tty:
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            self._termios = termios

    def pending(self):
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if not ch:
                break
            keys.append(ch)
        return keys

    def close(self):
        if self._tty:
            self._termios.tcsetattr(
                self._fd, self._termios.TCSADRAIN, self._old
            )


def _open_joystick():
    """First pygame joystick, or a helpful error (pygame is optional —
    import-guarded exactly like the reference's pynput/X11 deps)."""
    try:
        import pygame
    except ImportError as e:  # pragma: no cover - env without pygame
        raise RuntimeError(
            "joystick teleop needs pygame (pip install pygame); "
            "keyboard teleop works without it"
        ) from e
    pygame.init()
    pygame.joystick.init()
    if pygame.joystick.get_count() == 0:
        raise RuntimeError("no joystick found")
    js = pygame.joystick.Joystick(0)
    js.init()
    print(f"Joystick initialized: {js.get_name()}")
    return js, pygame


def joystick_offsets(js):
    """Reference axis mapping (``teleop_joystick.py:49-55``): stick axes
    scale the per-tick step — x = -axis1, y = axis0, z = -axis4.
    Returns [(axis, amount), ...] compatible with the keyboard offsets
    (amount is fractional where keys are ±1)."""
    return [
        (0, -js.get_axis(1)),
        (1, js.get_axis(0)),
        (2, -js.get_axis(4)),
    ]


def run_teleop(mode="rtde", hardware=False, ip="192.168.1.102", rate=0.05,
               step=0.001, max_ticks=None, script=None, joystick=None,
               verbose=True, device=None):
    """Drive the arm from the keyboard or a joystick. ``script`` (a
    string of keys) replaces live input for tests/headless use;
    ``joystick`` is any object with ``get_axis(i)`` (True opens the
    first pygame joystick). The robot lives on ``device`` (default: the
    card). Returns the number of ticks."""
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    opts = load_problem("ur10", "rot_free")
    robot = make_robot(opts, device=device)

    if mode == "rtde":
        from reconplan_tpu_torch.io.drivers import SimRTDE, Teleop

        if hardware and ip:
            from reconplan_tpu_torch.io.drivers import HardwareRTDE

            rtde = HardwareRTDE(ip)
        else:
            rtde = SimRTDE(robot, device=robot.device)
        teleop = Teleop(rtde, step=step)

        def apply(offsets):
            for axis, direction in offsets:
                teleop.nudge(axis, direction)
            return teleop.tick()[:3]

        def stop():
            rtde.stop_script()

    else:  # grr
        from reconplan_tpu_torch.grr import RedundancyResolution

        grr = RedundancyResolution(robot, robot.device)
        d = os.path.join(GRAPH_DIR, "ur10", "rot_free")
        grr.load_workspace_graph(os.path.join(d, "workspace.npz"))
        grr.load_resolution_graph(os.path.join(d, "resolution.npz"))
        sv = os.path.join(d, "solver.npz")
        if os.path.exists(sv):
            grr.load_solver_graph(sv)
        state = {
            "q": np.asarray(grr.configs[0], dtype=np.float64),
        }
        state["target"] = robot.fk_point_batch(
            state["q"][None])[0, :3].cpu().numpy().astype(np.float64)

        def apply(offsets):
            for axis, direction in offsets:
                state["target"][axis] += direction * step
            q = grr.teleop_solve(state["target"].copy(), state["q"], 0.04)
            if q is not None:
                state["q"] = np.asarray(q, dtype=np.float64)
            return state["target"]

        def stop():
            pass

    if verbose:
        src = "joystick" if joystick else "w/s=+-X a/d=+-Y i/j=+-Z q=quit"
        print(f"teleop: {src} "
              f"(mode={mode}, step={step*1000:.0f} mm, rate={1/rate:.0f} Hz)")

    pygame = None
    if joystick is True:
        joystick, pygame = _open_joystick()
    scripted = list(script) if script is not None else None
    reader = (
        None if (scripted is not None or joystick is not None)
        else _RawKeys()
    )
    ticks = 0
    try:
        while True:
            if scripted is not None:
                if not scripted:
                    break
                keys = [scripted.pop(0)]
            elif joystick is not None:
                keys = []
                if pygame is not None:  # drain the event queue (QUIT etc.)
                    for ev in pygame.event.get():
                        if ev.type == pygame.QUIT:
                            keys = ["q"]
                            break
            else:
                keys = reader.pending()
            if "q" in keys:
                break
            if joystick is not None:
                offsets = [
                    (a, v) for a, v in joystick_offsets(joystick)
                    if abs(v) > 0.05  # stick dead zone
                ]
            else:
                offsets = [KEYMAP[k] for k in keys if k in KEYMAP]
            pos = apply(offsets)
            ticks += 1
            if verbose and (offsets or ticks % 50 == 0):
                print(f"\r tick {ticks}  tool [{pos[0]:+.3f} {pos[1]:+.3f} "
                      f"{pos[2]:+.3f}]", end="", flush=True)
            if max_ticks is not None and ticks >= max_ticks:
                break
            if scripted is None:
                time.sleep(rate)
    finally:
        if reader is not None:
            reader.close()
        stop()
        if verbose:
            print()
    return ticks


def run_html_teleop(roadmap_dir, host="127.0.0.1", port=8008,
                    rotation_type=None, device=None):
    """Serve the pointer-teleop UI (klampt_vis.py:369-426 twin) over a
    local HTTP bridge — see :mod:`reconplan_tpu_torch.viz.teleop_server`;
    the solves run on ``device`` (default: the card)."""
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot
    from reconplan_tpu_torch.viz.teleop_server import serve_teleop

    if rotation_type is None:
        rotation_type = "rot_free"
        for rt in ("rot_variable_yaw", "rot_fixed"):
            if rt in str(roadmap_dir):
                rotation_type = rt
    opts = load_problem("ur10", rotation_type)
    robot = make_robot(opts, device=device)
    grr = RedundancyResolution(robot, robot.device)
    grr.load_workspace_graph(os.path.join(roadmap_dir, "workspace.npz"))
    grr.load_resolution_graph(os.path.join(roadmap_dir, "resolution.npz"))
    sv = os.path.join(roadmap_dir, "solver.npz")
    if os.path.exists(sv):
        grr.load_solver_graph(sv)
    return serve_teleop(grr, host=host, port=port, device=robot.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["rtde", "grr", "html"], default="rtde")
    ap.add_argument("--hardware", action="store_true")
    ap.add_argument("--ip", default="192.168.1.102")
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--step", type=float, default=0.001)
    ap.add_argument("--roadmap", default="graph/ur10/rot_variable_yaw",
                    help="roadmap for --mode html/grr")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--joystick", action="store_true",
                    help="read the first pygame joystick instead of the "
                    "keyboard (teleop_joystick.py rebuild)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)
    if args.mode == "html":
        run_html_teleop(args.roadmap, port=args.port, device=args.device)
        return
    run_teleop(
        mode=args.mode, hardware=args.hardware, ip=args.ip,
        rate=args.rate, step=args.step,
        joystick=True if args.joystick else None, device=args.device,
    )


if __name__ == "__main__":
    main()
