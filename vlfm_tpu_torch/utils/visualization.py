"""Host-side rendering utilities: the port's copy of
``vlfm_tpu/utils/visualization.py`` (numpy and cv2; rendering never runs
on the device). The maps it draws are numpy arrays read off the device.

Parity targets: vlfm/utils/visualization.py (text banners, image padding),
vlfm/mapping/traj_visualizer.py (trajectory polylines + agent marker),
ValueMap.visualize / ObstacleMap.visualize (map renderers), and the
HabitatVis frame compositor (vlfm/utils/habitat_visualizer.py:139-192).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from vlfm_tpu_torch.mapping.grid import GridSpec2D


# --- text / layout ----------------------------------------------------------
def text_banner(text: str, width: int, font_scale: float = 0.6) -> np.ndarray:
    """White banner with word-wrapped black text (visualization.py:31-95)."""
    font = cv2.FONT_HERSHEY_SIMPLEX
    words = text.split()
    lines: List[str] = []
    cur = ""
    for w in words:
        trial = (cur + " " + w).strip()
        (tw, _), _ = cv2.getTextSize(trial, font, font_scale, 1)
        if tw > width - 20 and cur:
            lines.append(cur)
            cur = w
        else:
            cur = trial
    if cur:
        lines.append(cur)
    line_h = int(30 * font_scale / 0.6)
    img = np.full((line_h * max(len(lines), 1) + 10, width, 3), 255, np.uint8)
    for i, line in enumerate(lines):
        cv2.putText(img, line, (10, (i + 1) * line_h), font, font_scale, (0, 0, 0), 1, cv2.LINE_AA)
    return img


def add_text_to_image(img: np.ndarray, text: str, top: bool = True) -> np.ndarray:
    banner = text_banner(text, img.shape[1])
    return np.vstack([banner, img] if top else [img, banner])


def pad_images_to_match(images: Sequence[np.ndarray], axis: int = 0) -> List[np.ndarray]:
    """Pad with white so all images share the non-stack dimension."""
    other = 1 - axis
    target = max(im.shape[other] for im in images)
    out = []
    for im in images:
        pad = target - im.shape[other]
        before, after = pad // 2, pad - pad // 2
        widths = [(0, 0), (0, 0), (0, 0)]
        widths[other] = (before, after)
        out.append(np.pad(im, widths, constant_values=255))
    return out


# --- trajectory -------------------------------------------------------------
class TrajectoryVisualizer:
    """Incremental path polyline + agent marker (traj_visualizer.py:9-114)."""

    def __init__(self, spec: GridSpec2D, path_color=(0, 255, 0), path_thickness: int = 3):
        self.spec = spec
        self.path_color = path_color
        self.path_thickness = path_thickness

    def _px(self, xy: np.ndarray) -> Tuple[int, int]:
        r = int(round(xy[0] * self.spec.pixels_per_meter)) + self.spec.origin
        c = self.spec.origin - int(round(xy[1] * self.spec.pixels_per_meter))
        return c, r  # cv2 point order (x=col, y=row)

    def draw_trajectory(self, img: np.ndarray, positions: Sequence[np.ndarray], yaw: float) -> np.ndarray:
        pts = [self._px(np.asarray(p)) for p in positions]
        for a, b in zip(pts[:-1], pts[1:]):
            cv2.line(img, a, b, self.path_color, self.path_thickness)
        if pts:
            self.draw_agent(img, np.asarray(positions[-1]), yaw)
        return img

    def draw_agent(self, img: np.ndarray, xy: np.ndarray, yaw: float, radius: int = 6) -> np.ndarray:
        c = self._px(xy)
        cv2.circle(img, c, radius, (255, 192, 15), -1)
        tip = (
            int(c[0] - radius * 2 * np.sin(yaw)),
            int(c[1] + radius * 2 * np.cos(yaw)),
        )
        cv2.line(img, c, tip, (0, 0, 255), 2)
        return img

    def draw_circle(self, img: np.ndarray, xy: np.ndarray, radius: int = 5, color=(0, 0, 255), thickness: int = 2) -> np.ndarray:
        cv2.circle(img, self._px(np.asarray(xy)), radius, color, thickness)
        return img


def rotate_image(img: np.ndarray, yaw_rad: float, border_value=(255, 255, 255)) -> np.ndarray:
    """Rotate about the image center, padding with ``border_value`` — the
    img_utils.rotate_image role used for start-yaw map reorientation
    (habitat_visualizer.py:122-137)."""
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), float(np.rad2deg(yaw_rad)), 1.0)
    return cv2.warpAffine(img, m, (w, h), borderValue=border_value)


def paint_target_cloud(
    img: np.ndarray,
    spec: GridSpec2D,
    points_xy: np.ndarray,  # (N, 2) episodic meters
    downsample: int = 1,
    color=(255, 0, 255),
) -> np.ndarray:
    """Paint the detected-object point cloud's footprint onto a rendered map —
    the color_point_cloud_on_map role (habitat_visualizer.py:228-253; the
    reference paints MAP_TARGET_POINT_INDICATOR pixels onto the habitat
    top-down map)."""
    pts = np.asarray(points_xy, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return img
    rows = np.rint(pts[:, 0] * spec.pixels_per_meter).astype(int) + spec.origin
    cols = spec.origin - np.rint(pts[:, 1] * spec.pixels_per_meter).astype(int)
    rows //= downsample
    cols //= downsample
    keep = (rows >= 0) & (rows < img.shape[0]) & (cols >= 0) & (cols < img.shape[1])
    img[rows[keep], cols[keep]] = color
    return img


# --- map renderers ------------------------------------------------------------
def render_value_map(
    values: np.ndarray,  # (H, W) reduced value channel
    spec: GridSpec2D,
    traj: Optional[TrajectoryVisualizer] = None,
    positions: Sequence[np.ndarray] = (),
    yaw: float = 0.0,
    markers: Sequence[Tuple[np.ndarray, Dict]] = (),
) -> np.ndarray:
    """Inferno colormap with unseen cells white (value_map.py:189-219)."""
    img = values.copy()
    zero = img == 0
    peak = img.max() if img.max() > 0 else 1.0
    img = (img / peak * 255).astype(np.uint8)
    out = cv2.applyColorMap(img, cv2.COLORMAP_INFERNO)
    out[zero] = (255, 255, 255)
    if traj and len(positions):
        traj.draw_trajectory(out, positions, yaw)
    for pos, kw in markers:
        (traj or TrajectoryVisualizer(spec)).draw_circle(out, pos, **kw)
    return out


def render_obstacle_map(
    obstacles: np.ndarray,
    navigable: np.ndarray,
    explored: np.ndarray,
    frontiers_px: np.ndarray = (),
    traj: Optional[TrajectoryVisualizer] = None,
    positions: Sequence[np.ndarray] = (),
    yaw: float = 0.0,
) -> np.ndarray:
    """Explored green, padding gray, obstacles black, frontiers blue circles
    (obstacle_map.py:171-193)."""
    h, w = obstacles.shape
    out = np.full((h, w, 3), 255, np.uint8)
    out[explored] = (200, 255, 200)
    out[~navigable] = (100, 100, 100)
    out[obstacles] = (0, 0, 0)
    for f in np.asarray(frontiers_px).reshape(-1, 2):
        cv2.circle(out, (int(f[1]), int(f[0])), 5, (200, 0, 0), 2)
    if traj and len(positions):
        traj.draw_trajectory(out, positions, yaw)
    return out


def compose_frame(
    rgb: np.ndarray,
    depth: np.ndarray,
    maps: Sequence[np.ndarray],
    texts: Sequence[str] = (),
) -> np.ndarray:
    """Egocentric column | map grid layout (habitat_visualizer.py:139-192)."""
    if depth.ndim == 2:
        depth = cv2.cvtColor((depth * 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    left = np.vstack(pad_images_to_match([rgb, depth], axis=0))
    sized = [cv2.resize(m, (left.shape[1], left.shape[1])) for m in maps]
    right = np.vstack(sized) if sized else np.full_like(left, 255)
    lh, rh = left.shape[0], right.shape[0]
    if lh < rh:
        left = np.pad(left, ((0, rh - lh), (0, 0), (0, 0)), constant_values=255)
    elif rh < lh:
        right = np.pad(right, ((0, lh - rh), (0, 0), (0, 0)), constant_values=255)
    frame = np.hstack([left, right])
    for t in texts:
        frame = add_text_to_image(frame, t, top=False)
    return frame


# ---------------------------------------------------------------------------
# Host-side display helpers (reference img_utils.py parity: the map/video
# compositing surface a reference user expects)
# ---------------------------------------------------------------------------
def place_img_in_img(base: np.ndarray, img: np.ndarray, row: int, col: int) -> np.ndarray:
    """Paste ``img`` centred at (row, col) of ``base``, cropping overhang
    (img_utils.place_img_in_img:31-61). Mutates and returns ``base``."""
    assert 0 <= row < base.shape[0] and 0 <= col < base.shape[1], (
        "Pixel location is outside the image."
    )
    top, left = row - img.shape[0] // 2, col - img.shape[1] // 2
    b_top, b_left = max(0, top), max(0, left)
    b_bot = min(base.shape[0], top + img.shape[0])
    b_right = min(base.shape[1], left + img.shape[1])
    i_top, i_left = b_top - top, b_left - left
    base[b_top:b_bot, b_left:b_right] = img[
        i_top : i_top + (b_bot - b_top), i_left : i_left + (b_right - b_left)
    ]
    return base


def monochannel_to_inferno_rgb(image: np.ndarray) -> np.ndarray:
    """Min-max normalize a float image and apply the Inferno colormap
    (img_utils.monochannel_to_inferno_rgb:64-86; BGR, like cv2)."""
    import cv2

    ptp = float(np.max(image) - np.min(image))
    norm = np.zeros_like(image) if ptp == 0 else (image - np.min(image)) / ptp
    return cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_INFERNO)


def resize_images(images, match_dimension: str = "height", use_max: bool = True):
    """Rescale a list of images to a common height or width
    (img_utils.resize_images:88-121)."""
    import cv2

    if len(images) == 1:
        return list(images)
    if match_dimension == "height":
        h = (max if use_max else min)(im.shape[0] for im in images)
        return [
            cv2.resize(im, (int(im.shape[1] * h / im.shape[0]), h)) for im in images
        ]
    if match_dimension == "width":
        w = (max if use_max else min)(im.shape[1] for im in images)
        return [
            cv2.resize(im, (w, int(im.shape[0] * w / im.shape[1]))) for im in images
        ]
    raise ValueError("Invalid 'match_dimension' argument. Use 'height' or 'width'.")


def resize_image(img: np.ndarray, new_height: int) -> np.ndarray:
    """Aspect-preserving resize to a target height (img_utils.resize_image)."""
    import cv2

    w = int(new_height * img.shape[1] / img.shape[0])
    return cv2.resize(img, (w, new_height), interpolation=cv2.INTER_AREA)


def crop_white_border(image: np.ndarray) -> np.ndarray:
    """Crop to the bounding box of non-white pixels
    (img_utils.crop_white_border:123-149)."""
    import cv2

    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    nz = np.argwhere(gray != 255)
    if len(nz) == 0:
        return image
    (r0, c0), (r1, c1) = nz.min(axis=0), nz.max(axis=0)
    return image[r0 : r1 + 1, c0 : c1 + 1, :]


def pad_to_square(img: np.ndarray, padding_color=(255, 255, 255), extra_pad: int = 0) -> np.ndarray:
    """Pad the smaller dimension so the image is square
    (img_utils.pad_to_square:151-176)."""
    side = max(img.shape[0], img.shape[1]) + extra_pad
    out = np.ones((side, side, 3), np.uint8) * np.asarray(padding_color, np.uint8)
    return place_img_in_img(out, img, side // 2, side // 2)


def pad_larger_dim(image: np.ndarray, target_dimension: int) -> np.ndarray:
    """Whitespace-pad along the larger dimension up to a minimum size
    (img_utils.pad_larger_dim:178-211)."""
    h, w = image.shape[:2]
    larger = max(h, w)
    if larger >= target_dimension:
        return image
    pad = target_dimension - larger
    a, b = pad // 2, pad - pad // 2
    if h > w:
        return np.vstack([
            np.full((a, w, 3), 255, np.uint8), image, np.full((b, w, 3), 255, np.uint8)
        ])
    return np.hstack([
        np.full((h, a, 3), 255, np.uint8), image, np.full((h, b, 3), 255, np.uint8)
    ])


def reorient_rescale_map(vis_map_img: np.ndarray) -> np.ndarray:
    """Display prep for rendered maps: crop whitespace, pad to >= 150 px,
    square, then a 50 px white border (img_utils.reorient_rescale_map:297-321;
    consumed by habitat_visualizer.py:135, objectnav_env.py:81,
    semexp eval.py:156)."""
    import cv2

    out = crop_white_border(vis_map_img)
    out = pad_larger_dim(out, 150)
    out = pad_to_square(out, extra_pad=50)
    return cv2.copyMakeBorder(
        out, 50, 50, 50, 50, cv2.BORDER_CONSTANT, value=(255, 255, 255)
    )


def remove_small_blobs(image: np.ndarray, min_area: int) -> np.ndarray:
    """Zero out connected components smaller than ``min_area``
    (img_utils.remove_small_blobs:323-336)."""
    import cv2

    contours, _ = cv2.findContours(image, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
    for c in contours:
        if cv2.contourArea(c) < min_area:
            cv2.drawContours(image, [c], -1, 0, -1)
    return image


def median_blur_normalized_depth_image(depth_image: np.ndarray, ksize: int) -> np.ndarray:
    """Median blur through a u8 round trip (img_utils:269-295)."""
    import cv2

    u8 = (depth_image * 255).astype(np.uint8)
    return cv2.medianBlur(u8, ksize).astype(np.float32) / 255


def flatten_dict(d: dict, parent_key: str = "") -> dict:
    """Nested dict -> dotted-key flat dict (habitat's helper used by
    overlay_frame; lists are kept as values, not recursed)."""
    out = {}
    for k, v in d.items():
        key = f"{parent_key}.{k}" if parent_key else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key))
        else:
            out[key] = v
    return out


def overlay_frame(frame: np.ndarray, info: dict, additional=None) -> np.ndarray:
    """Render the info dict's scalar/string metrics as small text lines onto
    the frame (habitat_visualizer.overlay_frame:256-276; the reference
    delegates pixel drawing to habitat's overlay_text_to_image — here the
    lines render with cv2 directly, same content and ordering)."""
    import cv2

    lines = []
    for k, v in flatten_dict(info).items():
        if isinstance(v, str):
            lines.append(f"{k}: {v}")
        else:
            try:
                lines.append(f"{k}: {v:.2f}")
            except TypeError:
                pass
    if additional is not None:
        lines.extend(additional)
    out = frame.copy()
    y = 12
    for line in lines:
        cv2.putText(out, line, (4, y), cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                    (0, 0, 0), 2, cv2.LINE_AA)
        cv2.putText(out, line, (4, y), cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                    (255, 255, 255), 1, cv2.LINE_AA)
        y += 14
    return out
