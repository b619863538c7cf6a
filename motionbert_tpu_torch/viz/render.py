"""Motion rendering: 2D skeleton, 3D skeleton and mesh videos, drawn with
OpenCV and encoded with ``cv2.VideoWriter``.

The port of ``motionbert_tpu/viz/render.py`` (reference
lib/utils/vismo.py). ``render_and_save`` dispatches on the shape as there:

- (T, J, 2), or (T, J, 3) with with_conf=True: the 2D ellipse-limb skeleton
  (``joints2image``, the JAX module's cv2 drawing calls, so its frames are
  pixel-equal to the JAX module's), normalised coordinates mapped to pixels
  by ``pixel2world_vis_motion``;
- (T, 6890, 3): the mesh, its faces filled back to front and shaded by
  their normals (``mesh_frames``);
- (T, J, 3): the 3D skeleton (``skeleton3d_frames``).

Where the JAX module draws the 3D skeleton and the mesh with matplotlib,
this one projects explicitly (``project``) onto a 400 x 400 frame, the size
of the JAX module's 4 x 4 inch, 100 dpi figure: the skeleton from the JAX
module's view (elevation 12, azimuth 80, axes (-x, -z, -y)), the mesh as
the camera sees it (x right, y down, orthographic). Frame generation is
separate from encoding (``save_video``), and a video that cannot be written
raises: this module never falls back to image files.
"""

from __future__ import annotations

import math
import os

import numpy as np

# H36M-17 skeleton edges (matches the limb topology, geometry.skeleton)
SKELETON_EDGES = [
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8), (8, 9),
    (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15), (15, 16),
]
LEFT_JOINTS = {4, 5, 6, 11, 12, 13}
RIGHT_JOINTS = {1, 2, 3, 14, 15, 16}

# the 3D and mesh frames: the JAX module's figure of 4 x 4 inches at 100 dpi
FRAME_SIZE = 400
# the 3D skeleton's view (the JAX module's view_init(elev=12, azim=80))
ELEV, AZIM = 12.0, 80.0
MESH_COLOR = (0xdd, 0xdd, 0xdd)
# the mesh's faces are filled in depth slices, each slice's faces in shade
# buckets: at most DEPTH_SLICES * SHADES fill calls a frame
DEPTH_SLICES, SHADES = 48, 16


def hex2rgb(hex_str: str, number_of_colors: int = 3):
    """Split a concatenated hex string into RGB triples (vismo.py:77-86)."""
    h = hex_str
    rgb = []
    for _ in range(number_of_colors):
        h = h.lstrip("#")
        rgb.append([int(h[i:i + 2], 16) for i in (0, 2, 4)])
        h = h[6:]
    return rgb


def rgb2rgba(color):
    return (color[0], color[1], color[2], 255)


def bounding_box(img):
    """(min_row, max_row, min_col, max_col) of nonzero pixels
    (vismo.py:344-347); an empty box for an all-zero image."""
    a = np.where(img != 0)
    if a[0].size == 0:
        return 0, 0, 0, 0
    return np.min(a[0]), np.max(a[0]), np.min(a[1]), np.max(a[1])


def pixel2world_vis(pose):
    """(J, 2) normalized [-1,1] -> pixels in a 512-box (vismo.py:39-41)."""
    return (np.asarray(pose, np.float32) + [1, 1]) * 512 / 2


def pixel2world_vis_motion(motion, dim=2):
    """(J, dim, T) normalized -> pixel coords; depth is left unshifted for
    dim=3 (vismo.py:43-53)."""
    motion = np.asarray(motion, np.float32)
    offset = np.ones((dim, motion.shape[-1]), np.float32)
    if dim == 3:
        offset[2] = 0
    return (motion + offset) * 512 / 2


# Limb topology + L/M/R color assignment per joint count (vismo.py:93-146).
# 49 = basic(15) + eyes(2, not drawn) + toes(2) + hands(30); 17 = H36M.
def _topology(nr_joints):
    if nr_joints == 49:
        limbs = [[0, 1], [1, 2], [1, 5], [1, 8], [2, 3], [3, 4], [5, 6],
                 [6, 7], [8, 9], [8, 13], [9, 10], [10, 11], [11, 12],
                 [13, 14], [14, 15], [15, 16]]
        joints_lmr = "MMLLLRRRMLLLLRRRRRL" + "L" * 15 + "R" * 15
        limbs_lmr = "MLRMLLRRLRLLLRRRRR"[:len(limbs)]
    elif nr_joints == 15:
        limbs = [[0, 1], [1, 2], [1, 5], [1, 8], [2, 3], [3, 4], [5, 6],
                 [6, 7], [8, 9], [8, 12], [9, 10], [10, 11], [12, 13],
                 [13, 14]]
        joints_lmr = "MMLLLRRRMLLLRRR"
        limbs_lmr = "MLRMLLRRLRLLRR"
    elif nr_joints == 17:
        limbs = [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7],
                 [7, 8], [8, 9], [8, 11], [8, 14], [9, 10], [11, 12],
                 [12, 13], [14, 15], [15, 16]]
        joints_lmr = "MRRRLLLMMMMLLLRRR"
        limbs_lmr = "RRRLLLMMMLRMLLRR"
    else:
        raise ValueError("Only support number of joints be 49 or 17 or 15")
    return limbs, joints_lmr, limbs_lmr


def joints2image(joints_position, colors, transparency=False, H=1000,
                 W=1000, nr_joints=None, imtype=np.uint8, grayscale=False,
                 bg_color=(255, 255, 255)):
    """Draw one pose as filled joints + alpha-blended ellipse limbs.

    joints_position: (J, 2) or (J, 3) with confidence in the last channel —
    zero-confidence joints/limbs are skipped. colors: three RGB triples
    (left / middle / right). Returns [canvas, canvas_cropped] like
    vismo.py:89-213 (crop over the nonzero column range).
    """
    import cv2

    joints_position = np.asarray(joints_position)
    limbs, joints_lmr, limbs_lmr = _topology(joints_position.shape[0])
    cmap = {"L": rgb2rgba(colors[0]) if transparency else colors[0],
            "M": rgb2rgba(colors[1]) if transparency else colors[1],
            "R": rgb2rgba(colors[2]) if transparency else colors[2]}
    colors_joints = [cmap[c] for c in joints_lmr]
    colors_limbs = [cmap[c] for c in limbs_lmr]

    if transparency:
        canvas = np.zeros((H, W, 4))
    else:
        canvas = np.ones((H, W, 3)) * np.array(bg_color).reshape(1, 1, 3)

    joints_radius = 7
    for i in range(len(colors_joints)):
        if i in (17, 18) and joints_position.shape[0] == 49:
            continue  # eyes are not drawn (vismo.py:166-167)
        radius = 2 if i > 18 else joints_radius
        if joints_position.shape[1] == 3 and joints_position[i][2] == 0:
            continue
        cv2.circle(canvas,
                   (int(joints_position[i][0]), int(joints_position[i][1])),
                   radius, colors_joints[i], thickness=-1)

    canvas_cropped = canvas
    stickwidth = 2
    for i, (a, b) in enumerate(limbs):
        cur_canvas = canvas.copy()
        p1, p2 = joints_position[a], joints_position[b]
        if len(p1) == 3 and min(p1[2], p2[2]) == 0:
            bb = bounding_box(canvas)
            canvas_cropped = canvas[:, bb[2]:bb[3], :]
            continue
        X = [p1[1], p2[1]]
        Y = [p1[0], p2[0]]
        mX, mY = np.mean(X), np.mean(Y)
        length = ((X[0] - X[1]) ** 2 + (Y[0] - Y[1]) ** 2) ** 0.5
        angle = math.degrees(math.atan2(X[0] - X[1], Y[0] - Y[1]))
        polygon = cv2.ellipse2Poly((int(mY), int(mX)),
                                   (int(length / 2), stickwidth),
                                   int(angle), 0, 360, 1)
        cv2.fillConvexPoly(cur_canvas, polygon, colors_limbs[i])
        canvas = cv2.addWeighted(canvas, 0.4, cur_canvas, 0.6, 0)
        bb = bounding_box(canvas)
        canvas_cropped = canvas[:, bb[2]:bb[3], :]
    canvas = canvas.astype(imtype)
    canvas_cropped = canvas_cropped.astype(imtype)
    if grayscale:
        code = cv2.COLOR_RGBA2GRAY if transparency else cv2.COLOR_RGB2GRAY
        canvas = cv2.cvtColor(canvas, code)
        canvas_cropped = cv2.cvtColor(canvas_cropped, code)
    return [canvas, canvas_cropped]


def skeleton_frames(motion, colors, h=512, w=512, bg_color=(255, 255, 255),
                    transparency=False, motion_tgt=None, grayscale=False,
                    cropped=False) -> list:
    """The frames of ``motion2video``: motion (J, D, T), D 2 or 3 with
    confidence; motion_tgt blended under the prediction (0.3 / 0.7).
    cropped: each frame's nonzero column range instead."""
    import cv2

    motion = np.asarray(motion)
    frames = []
    for i in range(motion.shape[-1]):
        img, img_cropped = joints2image(
            motion[:, :, i], colors, transparency=transparency,
            bg_color=bg_color, H=h, W=w, grayscale=grayscale)
        if motion_tgt is not None:
            img_tgt, _ = joints2image(
                motion_tgt[:, :, i], colors, transparency=transparency,
                bg_color=bg_color, H=h, W=w, grayscale=grayscale)
            img = cv2.addWeighted(img_tgt, 0.3, img, 0.7, 0)
            bb = bounding_box(img)
            img_cropped = img[:, bb[2]:bb[3], :]
        frames.append(img_cropped if cropped else img)
    return frames


def motion2video(motion, save_path, colors, h=512, w=512,
                 bg_color=(255, 255, 255), transparency=False,
                 motion_tgt=None, fps=25, save_frame=False, grayscale=False,
                 as_array=False):
    """2D skeleton video via the ellipse renderer (vismo.py:213-244).

    motion: (J, D, T) in the reference's channel-second layout (D=2 or 3
    with confidence). motion_tgt, when given, is blended UNDER the
    prediction (0.3 target / 0.7 prediction) for side-by-side comparison.
    save_frame also writes each cropped frame as a PNG under
    ``<save_path without .mp4>-frames/``. as_array returns the (T, h, w, 3)
    frames as float64 instead of writing the video.
    """
    import cv2

    kw = dict(h=h, w=w, bg_color=bg_color, transparency=transparency,
              motion_tgt=motion_tgt, grayscale=grayscale)
    frames = skeleton_frames(motion, colors, **kw)
    if save_frame:
        frames_dir = save_path[:-4] + "-frames"
        os.makedirs(frames_dir, exist_ok=True)
        for i, img in enumerate(skeleton_frames(motion, colors, cropped=True,
                                                **kw)):
            if not cv2.imwrite(os.path.join(frames_dir, "%04d.png" % i),
                               _bgr(img)):
                raise OSError(f"could not write frame {i} to {frames_dir}")
    if as_array:
        return np.asarray(frames, np.float64)
    return save_video(frames, save_path, fps)


def vis_data_batch(data_input, data_label, n_render=10,
                   save_path="doodle/vis_train_data/"):
    """Render the first n pairs of a training batch (vismo.py:55-63).

    data_input: (N, T, J, 2|3); data_label: (N, T, J, 3).
    """
    os.makedirs(save_path, exist_ok=True)
    data_input = np.asarray(data_input)
    data_label = np.asarray(data_label)
    for i in range(min(len(data_input), n_render)):
        render_and_save(data_input[i][:, :, :2],
                        os.path.join(save_path, f"input_{i}.mp4"))
        render_and_save(data_label[i],
                        os.path.join(save_path, f"gt_{i}.mp4"))


def _bgr(frame: np.ndarray) -> np.ndarray:
    """An RGB, RGBA or grayscale frame as the uint8 BGR cv2 writes."""
    import cv2

    frame = np.asarray(frame).astype(np.uint8)
    if frame.ndim == 2:
        return cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
    if frame.shape[-1] == 4:
        return cv2.cvtColor(frame, cv2.COLOR_RGBA2BGR)
    return np.ascontiguousarray(frame[..., ::-1])


def save_video(frames, save_path, fps) -> str:
    """Encode RGB (or RGBA, or grayscale) frames of one size as an mp4
    (``mp4v``) with ``cv2.VideoWriter``; returns save_path. Raises when the
    writer does not open, the frames differ in size, or no file results."""
    import cv2

    if not frames:
        raise ValueError(f"no frames to write to {save_path}")
    h, w = np.asarray(frames[0]).shape[:2]
    writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (int(w), int(h)))
    if not writer.isOpened():
        raise OSError(f"cv2.VideoWriter cannot open {save_path} (mp4v)")
    try:
        for i, frame in enumerate(frames):
            frame = _bgr(frame)
            if frame.shape[:2] != (h, w):
                raise ValueError(f"frame {i} is {frame.shape[:2]}, the "
                                 f"video {(h, w)}")
            writer.write(frame)
    finally:
        writer.release()
    if not os.path.getsize(save_path):
        raise OSError(f"cv2.VideoWriter wrote nothing to {save_path}")
    return save_path


def project(points, lim: float, view: str, size: int = FRAME_SIZE):
    """Pixel coordinates (..., 2) and depth (...,) of 3D points (..., 3) on
    a size x size frame whose half-width is ``lim`` in the points' units.
    view "skeleton": the JAX module's 3D plot, axes (-x, -z, -y) seen from
    elevation ``ELEV`` and azimuth ``AZIM``; "mesh": the camera's own view
    (x right, y down, depth z). Orthographic; depth grows away from the
    viewer."""
    p = np.asarray(points, np.float64)
    if view == "skeleton":
        e, a = math.radians(ELEV), math.radians(AZIM)
        plot = np.stack([-p[..., 0], -p[..., 2], -p[..., 1]], -1)
        right = np.array([-math.sin(a), math.cos(a), 0.0])
        up = np.array([-math.sin(e) * math.cos(a),
                       -math.sin(e) * math.sin(a), math.cos(e)])
        toward = np.array([math.cos(e) * math.cos(a),
                           math.cos(e) * math.sin(a), math.sin(e)])
        u, v, depth = plot @ right, -(plot @ up), -(plot @ toward)
    elif view == "mesh":
        u, v, depth = p[..., 0], p[..., 1], p[..., 2]
    else:
        raise ValueError(f"view must be 'skeleton' or 'mesh', got {view!r}")
    half = size / 2.0
    return np.stack([half + u / lim * half, half + v / lim * half], -1), depth


def _edge_color(a: int, b: int) -> tuple:
    """The JAX module's 3D limb colours (RGB): left, right, middle."""
    if a in LEFT_JOINTS or b in LEFT_JOINTS:
        return (0x2e, 0x79, 0xc7)
    if a in RIGHT_JOINTS or b in RIGHT_JOINTS:
        return (0xe3, 0x5a, 0x5a)
    return (0x44, 0x44, 0x44)


def skeleton3d_frames(motion, size: int = FRAME_SIZE) -> list:
    """(T, 17, 3) -> T RGB frames of the 3D skeleton, the limbs drawn back
    to front, on one scale for the clip (``lim`` = 1.1 max|motion|, as the
    JAX module's axes)."""
    import cv2

    motion = np.asarray(motion, np.float64)
    lim = np.abs(motion).max() * 1.1 + 1e-6
    xy, depth = project(motion, lim, "skeleton", size)
    pix = np.round(xy).astype(np.int32)
    frames = []
    for t in range(motion.shape[0]):
        img = np.full((size, size, 3), 255, np.uint8)
        edges = sorted(SKELETON_EDGES,
                       key=lambda e: -(depth[t, e[0]] + depth[t, e[1]]))
        for a, b in edges:
            cv2.line(img, tuple(map(int, pix[t, a])),
                     tuple(map(int, pix[t, b])), _edge_color(a, b), 2,
                     cv2.LINE_AA)
        frames.append(img)
    return frames


def mesh_frames(verts, faces=None, size: int = FRAME_SIZE) -> list:
    """(T, V, 3) vertices -> T RGB frames of the mesh as the camera sees it,
    on one scale for the clip. With faces (F, 3) the faces are filled back
    to front (painter's order by mean depth) in ``MESH_COLOR`` shaded by
    |normal . view|: the depth-sorted faces go in ``DEPTH_SLICES`` slices,
    and each slice's faces of one of ``SHADES`` shades in one
    ``cv2.fillPoly`` call. Without faces every tenth vertex is a dot, as
    the JAX module scatters them."""
    import cv2

    verts = np.asarray(verts, np.float64)
    lim = np.abs(verts).max() * 1.1 + 1e-6
    xy, depth = project(verts, lim, "mesh", size)
    pix = np.round(xy).astype(np.int32)
    frames = []
    for t in range(verts.shape[0]):
        img = np.full((size, size, 3), 255, np.uint8)
        if faces is None:
            for x, y in pix[t, ::10]:
                cv2.circle(img, (int(x), int(y)), 1, (0x88, 0x88, 0x88), -1)
            frames.append(img)
            continue
        tri = verts[t][faces]                               # (F, 3, 3)
        normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        norm = np.linalg.norm(normal, axis=-1)
        shade = np.abs(normal[:, 2]) / np.maximum(norm, 1e-12)
        bucket = np.minimum((shade * SHADES).astype(np.int64), SHADES - 1)
        order = np.argsort(-depth[t][faces].mean(-1), kind="stable")
        polys = pix[t][faces]                               # (F, 3, 2)
        for chunk in np.array_split(order, DEPTH_SLICES):
            for k in np.unique(bucket[chunk]):
                sel = chunk[bucket[chunk] == k]
                level = 0.35 + 0.65 * (k + 0.5) / SHADES
                color = tuple(int(c * level) for c in MESH_COLOR)
                cv2.fillPoly(img, list(polys[sel]), color)
        frames.append(img)
    return frames


def motion2video_3d(motion, save_path, fps=25, keep_imgs=False):
    """motion: (T, 17, 3) -> 3D skeleton video."""
    return save_video(skeleton3d_frames(motion), save_path, fps)


def skeleton2d_line_frames(motion) -> list:
    """The frames of ``motion2video_2d``: (T, 17, >=2) pixel coordinates,
    lines and dots on a white square sized to the motion, RGB."""
    import cv2

    motion = np.asarray(motion)
    size = int(np.nanmax(motion[..., :2]) * 1.1) + 20
    size = max(min(size, 2048), 64)
    frames = []
    for t in range(motion.shape[0]):
        img = np.full((size, size, 3), 255, np.uint8)
        pose = motion[t]
        for a, b in SKELETON_EDGES:
            pa = tuple(np.round(pose[a, :2]).astype(int))
            pb = tuple(np.round(pose[b, :2]).astype(int))
            color = ((199, 90, 227)[::-1]
                     if (a in LEFT_JOINTS or b in LEFT_JOINTS)
                     else (90, 90, 227) if (a in RIGHT_JOINTS or
                                            b in RIGHT_JOINTS)
                     else (68, 68, 68))
            cv2.line(img, pa, pb, color, 2)
        for j in range(pose.shape[0]):
            cv2.circle(img, tuple(np.round(pose[j, :2]).astype(int)), 3,
                       (30, 30, 30), -1)
        frames.append(img[..., ::-1])
    return frames


def motion2video_2d(motion, save_path, fps=25):
    """motion: (T, 17, >=2) in pixel coords -> quick 2D line video (cv2).

    A lightweight alternative to the ellipse renderer for debugging; the
    reference-fidelity path is motion2video/joints2image.
    """
    return save_video(skeleton2d_line_frames(motion), save_path, fps)


def motion2video_mesh(verts, save_path, fps=25, faces=None):
    """verts: (T, 6890, 3) -> mesh video."""
    return save_video(mesh_frames(verts, faces), save_path, fps)


def _to_jdt(arr) -> np.ndarray:
    """(T, J, D) -> a fresh (J, 3, T), confidence 1 where D is 2, x and y in
    pixels of the 512-box."""
    a = np.transpose(np.asarray(arr, np.float32), (1, 2, 0))
    full = np.ones((a.shape[0], 3, a.shape[2]), np.float32)
    full[:, :a.shape[1]] = a[:, :3]
    full[:, :2] = pixel2world_vis_motion(full[:, :2])
    return full


def render_and_save(motion_input, save_path, keep_imgs=False, fps=25,
                    color="#F96706#FB8D43#FDB381", with_conf=False,
                    draw_face=False, faces=None, motion_tgt=None):
    """Shape-dispatching renderer (reference vismo.py:17-37 semantics):
    (T, J, 2) or with_conf -> 2D ellipse video in a 512-px box;
    (T, 6890, 3) -> mesh; (T, J, 3) -> 3D skeleton. Returns the path."""
    motion = np.asarray(motion_input, dtype=np.float32)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    if motion.ndim == 3 and motion.shape[1] == 6890:
        return motion2video_mesh(motion, save_path, fps=fps, faces=faces)
    if motion.ndim == 3 and (motion.shape[-1] == 2 or with_conf):
        tgt = None if motion_tgt is None else _to_jdt(motion_tgt)
        return motion2video(_to_jdt(motion), save_path, hex2rgb(color),
                            fps=fps, motion_tgt=tgt)
    if motion.ndim == 3 and motion.shape[-1] == 3:
        return motion2video_3d(motion, save_path, fps=fps,
                               keep_imgs=keep_imgs)
    raise ValueError(f"cannot infer render mode for shape {motion.shape}")
