"""Robot/camera drivers: the RTDE-shaped command sink and capture session.

Port of ``reconplan_tpu.io.drivers``, host-side shims mirroring the
reference's real-hardware layer:
  - ``UR10_RTDE/rtde/rtde.py`` (C20) -> :class:`RTDE` protocol +
    :class:`SimRTDE` (kinematic simulation backend) +
    :class:`HardwareRTDE` (binds to the real ``ur_rtde`` package when
    present on a robot-connected host).
  - ``data_recorder.py`` (C18)       -> :class:`DataCollector` (drives the
    arm through targets, captures RGBD + metadata.json in the reference's
    on-disk format).
  - ``robot_control.py`` (C19)       -> :func:`play_ctraj`.
  - ``UR10_RTDE/examples/teleop_keyboard.py`` Teleop class (C28)
                                      -> :class:`Teleop`.

The command-sink protocol keeps hardware strictly host-side: the device
pipeline produces joint trajectories; a driver consumes them. The
hardware bindings (``rtde_control``, ``rtde_receive``, ``pyrealsense2``)
and PIL are imported where they are used, never when this module is.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.kin.chain import fk_all
from reconplan_tpu_torch.utils.device import robot_device


class RTDE:
    """Control-surface protocol of the reference RTDE wrapper
    (``UR10_RTDE/rtde/rtde.py:7-175``). Subclasses implement transport."""

    # receive
    def get_joint_values(self): raise NotImplementedError
    def get_joint_speed(self): raise NotImplementedError
    def get_tool_pose(self): raise NotImplementedError
    def get_tool_speed(self): raise NotImplementedError

    # control
    def set_tool_pose(self, tcp): raise NotImplementedError
    def move_joint(self, joint_values, speed=1.05, acceleration=1.4,
                   asynchronous=False): raise NotImplementedError
    def move_joint_trajectory(self, path, asynchronous=False):
        raise NotImplementedError
    def speed_joint(self, speeds, acceleration=0.5, time=0.0):
        raise NotImplementedError
    def servo_joint(self, joint_values, time=0.008, lookahead_time=0.1,
                    gain=300): raise NotImplementedError
    def move_tool(self, pose, speed=0.25, acceleration=1.2,
                  asynchronous=False): raise NotImplementedError
    def servo_tool(self, pose, time=0.008, lookahead_time=0.1, gain=300):
        raise NotImplementedError
    def stop(self): pass
    def stop_script(self): pass


class SimRTDE(RTDE):
    """Kinematic simulation backend: instantly (or rate-limited) tracks
    commanded joints, with FK through the framework's chain. The
    simulation stand-in for the real arm, like the reference's PyBullet
    clients but with zero native dependencies. ``device`` is where the
    servo model runs (the robot's; ``None`` names the card)."""

    def __init__(self, robot, q0=None, realtime=False, dynamics=None,
                 device=None):
        self.robot = robot
        self.q = np.zeros(robot.num_joints) if q0 is None else np.asarray(q0, dtype=np.float64)
        self.qd = np.zeros(robot.num_joints)
        self.realtime = realtime
        # dynamics: a kin.dynamics.ServoExecutor — move/servo commands
        # then advance the state through 240 Hz servo dynamics instead
        # of teleporting, so executed joints LAG the command (the
        # reference's PyBullet POSITION_CONTROL playback,
        # ``main.py:218-234``); pass dynamics=True for default gains
        if dynamics is True:
            from reconplan_tpu_torch.kin.dynamics import ServoExecutor

            dynamics = ServoExecutor(robot, device=device)
        elif dynamics is None:
            robot_device(robot, device)
        self.dynamics = dynamics
        self.command_log = []  # (method, payload) for tests/inspection

    def _servo_to(self, target, duration):
        res = self.dynamics.execute(
            np.asarray([max(duration, 1.0 / self.dynamics.hz)], np.float32),
            np.asarray(target, np.float32)[None],
            q0=self.q.astype(np.float32), qd0=self.qd.astype(np.float32),
        )
        self.q = res["q_ticks"][-1].astype(np.float64)
        self.qd = res["qd_ticks"][-1].astype(np.float64)

    def get_joint_values(self):
        return self.q.tolist()

    def get_joint_speed(self):
        return self.qd.tolist()

    def get_tool_pose(self):
        pos, rot = self.robot.solve_fk(self.q.astype(np.float32), index=-1)
        rotvec = maths.quat_to_rotvec(self.robot._tensor(rot)).cpu().numpy()
        return [*pos.tolist(), *rotvec.tolist()]

    def get_tool_speed(self):
        return [0.0] * 6

    def set_tool_pose(self, tcp):
        self.command_log.append(("set_tool_pose", list(tcp)))

    def move_joint(self, joint_values, speed=1.05, acceleration=1.4,
                   asynchronous=False):
        target = np.asarray(joint_values, dtype=np.float64)
        dist = np.abs(target - self.q).max()
        if self.realtime:
            time.sleep(min(float(dist) / max(speed, 1e-6), 2.0))
        if self.dynamics is not None:
            # moveJ is a BLOCKING move: servo for the nominal duration
            # plus a settle window (~6 servo time constants) so the
            # regulator converges like the real controller's blend-in;
            # streaming commands (servo_joint / trajectories) keep the
            # honest residual lag instead
            self._servo_to(
                target,
                float(dist) / max(speed, 1e-6) + 6.0 / self.dynamics.kp,
            )
        else:
            self.q = target
        self.command_log.append(("move_joint", target.tolist()))

    def move_joint_trajectory(self, path, asynchronous=False):
        if self.dynamics is not None and len(path):
            # one fused 240 Hz execution of the whole timestamped path
            qs = np.asarray([wp[:6] for wp in path], np.float32)
            speeds = np.asarray(
                [wp[6] if len(wp) > 6 else 1.05 for wp in path], np.float32
            )
            prev = np.concatenate([self.q[None].astype(np.float32), qs[:-1]])
            dt = np.abs(qs - prev).max(axis=1) / np.maximum(speeds, 1e-6)
            times = np.cumsum(np.maximum(dt, 1.0 / self.dynamics.hz))
            res = self.dynamics.execute(
                times, qs, q0=self.q.astype(np.float32),
                qd0=self.qd.astype(np.float32),
            )
            self.q = res["q_ticks"][-1].astype(np.float64)
            self.qd = res["qd_ticks"][-1].astype(np.float64)
            self.last_execution = res
        else:
            for wp in path:
                self.move_joint(wp[:6])
        self.command_log.append(("move_joint_trajectory", len(path)))

    def speed_joint(self, speeds, acceleration=0.5, time=0.0):
        self.qd = np.asarray(speeds, dtype=np.float64)
        self.command_log.append(("speed_joint", list(speeds)))

    def servo_joint(self, joint_values, time=0.008, lookahead_time=0.1,
                    gain=300):
        if self.dynamics is not None:
            self._servo_to(np.asarray(joint_values, np.float64), time)
        else:
            self.q = np.asarray(joint_values, dtype=np.float64)
        self.command_log.append(("servo_joint", list(joint_values)))

    def move_tool(self, pose, speed=0.25, acceleration=1.2, asynchronous=False):
        self.command_log.append(("move_tool", list(pose)))

    def servo_tool(self, pose, time=0.008, lookahead_time=0.1, gain=300):
        self.command_log.append(("servo_tool", list(pose)))


class HardwareRTDE(RTDE):
    """Binds to the real ``ur_rtde`` C++ bindings when installed (on a
    robot-connected host only). Same surface as the
    reference wrapper, default IP included (``rtde.py:8``)."""

    def __init__(self, robot_ip: str = "192.168.1.102"):
        import rtde_control  # noqa: F401 (hardware-host only)
        import rtde_receive

        self.rtde_c = rtde_control.RTDEControlInterface(robot_ip)
        self.rtde_r = rtde_receive.RTDEReceiveInterface(robot_ip)

    def get_joint_values(self): return self.rtde_r.getActualQ()
    def get_joint_speed(self): return self.rtde_r.getActualQd()
    def get_tool_pose(self): return self.rtde_r.getActualTCPPose()
    def get_tool_speed(self): return self.rtde_r.getActualTCPSpeed()
    def set_tool_pose(self, tcp): self.rtde_c.setTcp(tcp)

    def move_joint(self, joint_values, speed=1.05, acceleration=1.4,
                   asynchronous=False):
        self.rtde_c.moveJ(joint_values, speed, acceleration, asynchronous)

    def move_joint_trajectory(self, path, asynchronous=False):
        self.rtde_c.moveJ(path, asynchronous)

    def speed_joint(self, speeds, acceleration=0.5, time=0.0):
        self.rtde_c.speedJ(speeds, acceleration, time)

    def servo_joint(self, joint_values, time=0.008, lookahead_time=0.1,
                    gain=300):
        # 125 Hz servo defaults (rtde.py:107-133)
        self.rtde_c.servoJ(joint_values, 0.0, 0.0, time, lookahead_time, gain)

    def move_tool(self, pose, speed=0.25, acceleration=1.2, asynchronous=False):
        self.rtde_c.moveL(pose, speed, acceleration, asynchronous)

    def servo_tool(self, pose, time=0.008, lookahead_time=0.1, gain=300):
        self.rtde_c.servoL(pose, 0.0, 0.0, time, lookahead_time, gain)

    def stop(self): self.rtde_c.stopJ(2.0)
    def stop_script(self): self.rtde_c.stopScript()


class RealSenseCamera:
    """Binds to ``pyrealsense2`` when installed (on a camera-connected
    host only) — the hardware twin of
    :class:`reconplan_tpu_torch.io.render.SplatCamera`, mirroring the reference's
    capture setup (``data_recorder.py:55-153``): serial-matched device
    lookup, advanced-mode JSON configuration load, 640x480 Z16 depth +
    BGR8 color at 30 fps, and depth-to-color frame alignment.

    ``get_frames`` returns (depth_u16 (H, W), color_rgb_u8 (H, W, 3)) —
    the (depth, color) order :class:`DataCollector` consumes (the
    reference returned (color, depth) and swapped at the call site).
    """

    def __init__(self, config_file: str | None = "realsense_config.json",
                 serial: str | None = None, width=640, height=480, fps=30):
        import pyrealsense2 as rs  # noqa: F401 (camera-host only)

        self._rs = rs
        self.ctx = rs.context()
        self.pipeline = rs.pipeline(self.ctx)
        self.config = rs.config()

        device = None
        for dev in self.ctx.query_devices():
            sn = dev.get_info(rs.camera_info.serial_number)
            if serial is None or sn == serial:
                device = dev
                break
        if device is None:
            raise RuntimeError(
                f"no RealSense device found (serial={serial!r})"
            )
        self.device = device

        # advanced-mode JSON config (data_recorder.py:74-84)
        if config_file is not None and os.path.exists(config_file):
            adv = rs.rs400_advanced_mode(device)
            if not adv.is_enabled():
                adv.toggle_advanced_mode(True)
                time.sleep(2)
            with open(config_file) as f:
                adv.load_json(f.read())

        self.config.enable_device(
            device.get_info(rs.camera_info.serial_number)
        )
        self.config.enable_stream(
            rs.stream.depth, width, height, rs.format.z16, fps
        )
        self.config.enable_stream(
            rs.stream.color, width, height, rs.format.bgr8, fps
        )
        self.profile = self.pipeline.start(self.config)
        self.depth_scale = (
            device.first_depth_sensor().get_depth_scale()
        )
        self.align = rs.align(rs.stream.color)
        time.sleep(2)  # stabilization (data_recorder.py:102)

    @property
    def intrinsics(self):
        """(fx, fy, cx, cy) of the aligned (color) stream."""
        rs = self._rs
        s = self.profile.get_stream(rs.stream.color)
        i = s.as_video_stream_profile().get_intrinsics()
        return (i.fx, i.fy, i.ppx, i.ppy)

    def get_frames(self):
        frames = self.pipeline.wait_for_frames()
        aligned = self.align.process(frames)
        depth = aligned.get_depth_frame()
        color = aligned.get_color_frame()
        if not depth or not color:
            raise RuntimeError("failed to get frames from RealSense camera")
        import numpy as _np

        depth_img = _np.asanyarray(depth.get_data())
        color_bgr = _np.asanyarray(color.get_data())
        return depth_img, color_bgr[..., ::-1]  # BGR -> RGB

    def release(self):
        self.pipeline.stop()


# ---------------------------------------------------------------------------
# trajectory playback + capture (data_recorder.py / robot_control.py)
# ---------------------------------------------------------------------------


def read_joint_positions(ctraj_path, every_nth=20, base_offset=0.35 * np.pi):
    """Parse ctraj.txt targets the reference way (``data_recorder.py:404-432``
    / ``robot_control.py``): every Nth row, +0.35pi on the base joint,
    wrapped to [-pi, pi]."""
    import re

    targets = []
    with open(ctraj_path) as f:
        for k, line in enumerate(f):
            if k % every_nth:
                continue
            nums = re.findall(r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", line.split(",", 1)[1])
            q = np.array([float(x) for x in nums[:6]])
            q[0] += base_offset
            q = (q + np.pi) % (2 * np.pi) - np.pi
            targets.append(q)
    return np.asarray(targets)


def play_ctraj(rtde: RTDE, ctraj_path, speed=0.15, acceleration=0.15,
               blend=0.02):
    """Trajectory playback (``robot_control.py:50-67``): appends
    [speed, acc, blend] per waypoint and streams the whole path; always
    stops the script on exit."""
    targets = read_joint_positions(ctraj_path, every_nth=1)
    path = [[*q.tolist(), speed, acceleration, blend] for q in targets]
    try:
        rtde.move_joint_trajectory(path)
    finally:
        rtde.stop_script()
    return len(path)


@dataclass
class DataCollector:
    """Capture session (``data_recorder.py:183-321``): drive the arm to
    each target, grab an RGBD frame, save rgb/%04d.jpg + depth/%04d.npy +
    metadata.json in the reference's layout (which
    ``io.frames.load_rgbd_folder`` reads back)."""

    rtde: RTDE
    camera: object  # anything with .take_picture(eye, target) or .get_frames()
    out_dir: str = "robot_data"
    target_point: tuple = (0.75, 0.75, 0.0)

    def __post_init__(self):
        os.makedirs(os.path.join(self.out_dir, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(self.out_dir, "depth"), exist_ok=True)
        self.metadata = {"frames": [], "camera_intrinsics": None}

    def collect_data_from_targets(self, targets, robot=None):
        """Move -> capture per target; KeyboardInterrupt still writes
        metadata (reference failure-handling idiom, data_recorder.py:301-317)."""
        import PIL.Image

        try:
            for i, q in enumerate(targets):
                self.rtde.move_joint(q)
                frame = self._capture(robot)
                if frame is None:
                    continue
                depth, color = frame
                PIL.Image.fromarray(color).save(
                    os.path.join(self.out_dir, "rgb", f"{i:04d}.jpg")
                )
                np.save(os.path.join(self.out_dir, "depth", f"{i:04d}.npy"), depth)
                self.metadata["frames"].append(
                    {"index": i, "joints": list(map(float, self.rtde.get_joint_values())),
                     "tool_pose": list(map(float, self.rtde.get_tool_pose()))}
                )
        except KeyboardInterrupt:
            pass
        finally:
            if getattr(self.camera, "intrinsics", None) is not None:
                fx, fy, cx, cy = self.camera.intrinsics
                self.metadata["camera_intrinsics"] = {
                    "fx": fx, "fy": fy, "cx": cx, "cy": cy,
                }
            with open(os.path.join(self.out_dir, "metadata.json"), "w") as f:
                json.dump(self.metadata, f, indent=1)
        return len(self.metadata["frames"])

    def _capture(self, robot):
        if hasattr(self.camera, "get_frames"):
            return self.camera.get_frames()
        if robot is None:
            return None
        # synthetic camera: render from the robot's camera link
        q = robot._tensor(self.rtde.get_joint_values())
        full = robot._q_rest.index_copy(0, robot._active_idx, q)
        _, t = fk_all(robot.model, full)
        eye = t[robot.camera_link].cpu().numpy()
        depth, color, _ = self.camera.take_picture(eye, self.target_point)
        return depth.cpu().numpy(), color.cpu().numpy()


class Teleop:
    """Anchor-tracking teleop state machine
    (``UR10_RTDE/examples/teleop_keyboard.py:7-77``): an anchor pose plus
    an offset commanded at servo rate."""

    def __init__(self, rtde: RTDE, step=0.01):
        self.rtde = rtde
        self.step = step
        self.anchor = np.asarray(rtde.get_tool_pose(), dtype=np.float64)
        self.offset = np.zeros(6)

    def nudge(self, axis, direction):
        """Move the target one step along axis (0-5)."""
        self.offset[axis] += direction * self.step

    def tick(self):
        """Send one servo command toward anchor+offset (125 Hz loop body)."""
        target = self.anchor + self.offset
        self.rtde.servo_tool(target.tolist())
        return target

    def reanchor(self):
        self.anchor = np.asarray(self.rtde.get_tool_pose(), dtype=np.float64)
        self.offset[:] = 0.0
