"""Pure-numpy kinematic backend with the pybullet API subset used by
``pcfm_torch.datagen.simulate``.

The reference's data generation (make_dataset.py:423-532) runs pybullet
with **gravity off** and pure position control: physics contributes
nothing beyond URDF parsing, forward kinematics, and a servo that settles
joints onto their targets. This backend implements exactly that surface
in ~300 lines of numpy, so offline data generation works without the
pybullet binary wheel — when real pybullet IS installed it is preferred
(``simulate._require_pybullet`` tries it first) and this module is the
fallback / test double.

Implemented API (names and tuple layouts match pybullet):
  connect/isConnected/resetSimulation/setTimeStep/setGravity/
  setAdditionalSearchPath/loadURDF/getNumJoints/getJointInfo/
  setJointMotorControl2/stepSimulation/getJointState/getLinkState/
  getBasePositionAndOrientation/getVisualShapeData/getMatrixFromQuaternion
plus the constants the simulate shell reads. Joint/link indexing follows
pybullet: joints in URDF document order, link index j = child link of
joint j, base link = -1.

Servo model: critically-damped first-order position control — each
``stepSimulation`` moves a POSITION_CONTROL joint toward its target by at
most ``rate * dt`` and reports velocity (delta / dt), converging smoothly
so ``settle_multi_joints``'s pos/vel stability logic is genuinely
exercised (make_dataset.py:480-497 semantics).

The port's copy of ``pcfm/datagen/bullet_kin.py``: it imports nothing of ``pcfm``.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# pybullet constants (values match the real module)
JOINT_REVOLUTE = 0
JOINT_PRISMATIC = 1
JOINT_SPHERICAL = 2
JOINT_PLANAR = 3
JOINT_FIXED = 4
VELOCITY_CONTROL = 0
TORQUE_CONTROL = 1
POSITION_CONTROL = 2
DIRECT = 2
GUI = 1
URDF_USE_INERTIA_FROM_FILE = 2

_JOINT_TYPES = {"revolute": JOINT_REVOLUTE, "continuous": JOINT_REVOLUTE,
                "prismatic": JOINT_PRISMATIC, "planar": JOINT_PLANAR,
                "fixed": JOINT_FIXED, "floating": JOINT_FIXED}

# servo travel rate (units/s); fast enough to settle well inside the
# reference's max_settle_steps budget at dt=1/240, slow enough that the
# settle loop sees genuine motion
_SERVO_RATE = 4.0


def _floats(s: Optional[str], default: Tuple[float, ...]):
    if not s:
        return np.asarray(default, np.float64)
    return np.asarray([float(x) for x in s.split()], np.float64)


def quat_from_rpy(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw -> quaternion (x, y, z, w)."""
    r, p, y = [float(v) / 2.0 for v in rpy]
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    return np.asarray([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy], np.float64)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    n = np.linalg.norm(a)
    if n == 0:
        return np.asarray([0.0, 0.0, 0.0, 1.0])
    a = a / n
    s = math.sin(angle / 2.0)
    return np.asarray([a[0] * s, a[1] * s, a[2] * s,
                       math.cos(angle / 2.0)], np.float64)


def quat_mul(q1, q2) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.asarray([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], np.float64)


def quat_to_matrix(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.asarray([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ], np.float64)


def matrix_to_quat(m) -> np.ndarray:
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.asarray([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                           (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(1e-12, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def _pose_T(xyz, quat) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(quat)
    T[:3, 3] = np.asarray(xyz, np.float64)
    return T


@dataclass
class _Visual:
    link: int                       # -1 = base
    mesh_file: str                  # "" for primitive geometry
    scale: np.ndarray               # (3,)
    xyz: np.ndarray                 # local visual frame
    quat: np.ndarray


@dataclass
class _Joint:
    name: str
    jtype: int
    parent_link: int
    child_link: int
    xyz: np.ndarray
    quat: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float
    pos: float = 0.0
    vel: float = 0.0
    mode: int = VELOCITY_CONTROL
    target: float = 0.0
    force: float = 0.0


@dataclass
class _Body:
    urdf_dir: Path
    joints: List[_Joint] = field(default_factory=list)
    visuals: List[_Visual] = field(default_factory=list)
    link_names: List[str] = field(default_factory=list)   # index = link id


class KinematicsClient:
    """Singleton-style client mirroring pybullet's module-level API."""

    # re-export the constants as attributes so `p.JOINT_REVOLUTE` works on
    # an instance exactly like on the pybullet module
    JOINT_REVOLUTE = JOINT_REVOLUTE
    JOINT_PRISMATIC = JOINT_PRISMATIC
    JOINT_SPHERICAL = JOINT_SPHERICAL
    JOINT_PLANAR = JOINT_PLANAR
    JOINT_FIXED = JOINT_FIXED
    VELOCITY_CONTROL = VELOCITY_CONTROL
    TORQUE_CONTROL = TORQUE_CONTROL
    POSITION_CONTROL = POSITION_CONTROL
    DIRECT = DIRECT
    GUI = GUI
    URDF_USE_INERTIA_FROM_FILE = URDF_USE_INERTIA_FROM_FILE

    def __init__(self):
        self._connected = False
        self._dt = 1.0 / 240.0
        self._bodies: List[_Body] = []

    # ---- session ----
    def connect(self, mode=DIRECT):
        self._connected = True
        return 0

    def disconnect(self):
        self._connected = False

    def isConnected(self) -> bool:
        return self._connected

    def resetSimulation(self):
        self._bodies = []

    def setTimeStep(self, dt: float):
        self._dt = float(dt)

    def setGravity(self, gx, gy, gz):
        pass                        # kinematic backend: gravity is inert

    def setAdditionalSearchPath(self, path: str):
        pass

    # ---- URDF ----
    def loadURDF(self, path: str, useFixedBase: bool = False,
                 flags: int = 0, **kw) -> int:
        urdf = Path(path)
        root = ET.parse(str(urdf)).getroot()
        body = _Body(urdf_dir=urdf.parent)

        link_elems = root.findall("link")
        if not link_elems:
            raise ValueError(f"URDF has no links: {path}")
        joints_x = root.findall("joint")
        child_names = {j.find("child").get("link") for j in joints_x
                       if j.find("child") is not None}
        base_candidates = [l.get("name") for l in link_elems
                           if l.get("name") not in child_names]
        base_name = base_candidates[0] if base_candidates \
            else link_elems[0].get("name")

        # pybullet indexing: joint j's child link has link index j
        name_to_idx: Dict[str, int] = {base_name: -1}
        for ji, jx in enumerate(joints_x):
            child = jx.find("child").get("link")
            name_to_idx[child] = ji
            body.link_names.append(child)

        for jx in joints_x:
            origin = jx.find("origin")
            axis = jx.find("axis")
            limit = jx.find("limit")
            jtype = _JOINT_TYPES.get(jx.get("type", "fixed"), JOINT_FIXED)
            lower = upper = 0.0
            if jx.get("type") == "continuous":
                # pybullet convention: unlimited joints report
                # lower > upper (find_joints then applies the +-pi fixup).
                # Checked BEFORE the <limit> branch: real URDFs often give
                # continuous joints a <limit effort= velocity=> element,
                # and pybullet treats them as unlimited regardless of it.
                lower, upper = 1.0, -1.0
            elif limit is not None:
                # URDF spec: a missing lower/upper attribute defaults to 0
                # (pybullet's parser does the same) — NOT unlimited
                lower = float(limit.get("lower", "0") or "0")
                upper = float(limit.get("upper", "0") or "0")
            body.joints.append(_Joint(
                name=jx.get("name", f"joint_{len(body.joints)}"),
                jtype=jtype,
                parent_link=name_to_idx.get(
                    jx.find("parent").get("link"), -1),
                child_link=name_to_idx[jx.find("child").get("link")],
                xyz=_floats(origin.get("xyz") if origin is not None
                            else None, (0, 0, 0)),
                quat=quat_from_rpy(_floats(
                    origin.get("rpy") if origin is not None else None,
                    (0, 0, 0))),
                axis=_floats(axis.get("xyz") if axis is not None else None,
                             (1, 0, 0)),
                lower=lower, upper=upper))

        for lx in link_elems:
            li = name_to_idx.get(lx.get("name"), -1)
            for vx in lx.findall("visual"):
                origin = vx.find("origin")
                geom = vx.find("geometry")
                mesh = geom.find("mesh") if geom is not None else None
                fn = mesh.get("filename", "") if mesh is not None else ""
                scale = _floats(mesh.get("scale") if mesh is not None
                                else None, (1, 1, 1))
                body.visuals.append(_Visual(
                    link=li, mesh_file=fn, scale=scale,
                    xyz=_floats(origin.get("xyz") if origin is not None
                                else None, (0, 0, 0)),
                    quat=quat_from_rpy(_floats(
                        origin.get("rpy") if origin is not None else None,
                        (0, 0, 0)))))
        self._bodies.append(body)
        return len(self._bodies) - 1

    # ---- joints ----
    def getNumJoints(self, body_id: int) -> int:
        return len(self._bodies[body_id].joints)

    def getJointInfo(self, body_id: int, j: int) -> tuple:
        jt = self._bodies[body_id].joints[j]
        # pybullet's 17-tuple; the fields simulate.py reads are 1 (name),
        # 2 (type), 8 (lower), 9 (upper), 12 (child link name)
        return (j, jt.name.encode(), jt.jtype, -1, -1, 0, 0.0, 0.0,
                jt.lower, jt.upper, 0.0, 0.0,
                (self._bodies[body_id].link_names[jt.child_link]
                 if 0 <= jt.child_link < len(
                     self._bodies[body_id].link_names)
                 else "").encode(),
                tuple(jt.axis), tuple(jt.xyz), tuple(jt.quat),
                jt.parent_link)

    def setJointMotorControl2(self, body_id: int, j: int, controlMode: int,
                              targetPosition: float = 0.0,
                              targetVelocity: float = 0.0,
                              force: float = 0.0, **kw):
        jt = self._bodies[body_id].joints[j]
        jt.mode = int(controlMode)
        jt.target = float(targetPosition)
        jt.force = float(force)

    def stepSimulation(self):
        for body in self._bodies:
            for jt in body.joints:
                if jt.mode == POSITION_CONTROL and jt.force > 0:
                    tgt = jt.target
                    if jt.lower < jt.upper:           # limited joint
                        tgt = min(max(tgt, jt.lower), jt.upper)
                    delta = tgt - jt.pos
                    step = max(-_SERVO_RATE * self._dt,
                               min(_SERVO_RATE * self._dt, delta))
                    jt.pos += step
                    jt.vel = step / self._dt
                else:                                  # free / zero-force
                    jt.vel = 0.0

    def getJointState(self, body_id: int, j: int) -> tuple:
        jt = self._bodies[body_id].joints[j]
        return (jt.pos, jt.vel, (0.0,) * 6, 0.0)

    # ---- kinematics ----
    def _link_world(self, body: _Body) -> Dict[int, np.ndarray]:
        T = {-1: np.eye(4)}
        # joints are in URDF document order; parents always resolvable by
        # iterating until fixed point (trees are shallow; one pass usually
        # suffices, loop guards against child-before-parent ordering)
        pending = list(range(len(body.joints)))
        while pending:
            progressed = False
            rest = []
            for ji in pending:
                jt = body.joints[ji]
                if jt.parent_link not in T:
                    rest.append(ji)
                    continue
                Tj = _pose_T(jt.xyz, jt.quat)
                if jt.jtype == JOINT_REVOLUTE:
                    Tq = _pose_T((0, 0, 0),
                                 quat_from_axis_angle(jt.axis, jt.pos))
                elif jt.jtype in (JOINT_PRISMATIC, JOINT_PLANAR):
                    Tq = _pose_T(jt.axis / max(np.linalg.norm(jt.axis),
                                               1e-12) * jt.pos,
                                 (0, 0, 0, 1))
                else:
                    Tq = np.eye(4)
                T[jt.child_link] = T[jt.parent_link] @ Tj @ Tq
                progressed = True
            if not progressed:
                for ji in rest:       # orphaned joints: hang off the base
                    T[body.joints[ji].child_link] = np.eye(4)
                break
            pending = rest
        return T

    def getBasePositionAndOrientation(self, body_id: int) -> tuple:
        return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)

    def getLinkState(self, body_id: int, li: int,
                     computeForwardKinematics: int = 0) -> tuple:
        T = self._link_world(self._bodies[body_id]).get(li, np.eye(4))
        pos = tuple(T[:3, 3])
        orn = tuple(matrix_to_quat(T[:3, :3]))
        # pybullet 8-tuple; [4]/[5] are the world link-frame pose
        return (pos, orn, (0, 0, 0), (0, 0, 0, 1), pos, orn, (0, 0, 0),
                (0, 0, 0))

    def getVisualShapeData(self, body_id: int) -> list:
        body = self._bodies[body_id]
        out = []
        for v in body.visuals:
            out.append((body_id, v.link, 5, tuple(v.scale),
                        v.mesh_file.encode(), tuple(v.xyz), tuple(v.quat),
                        (1.0, 1.0, 1.0, 1.0)))
        return out

    def getMatrixFromQuaternion(self, q) -> tuple:
        return tuple(quat_to_matrix(q).reshape(-1))


_CLIENT: Optional[KinematicsClient] = None


def client() -> KinematicsClient:
    """The process-wide kinematic client (pybullet is also a singleton
    module under DIRECT mode)."""
    global _CLIENT
    if _CLIENT is None:
        _CLIENT = KinematicsClient()
    return _CLIENT
