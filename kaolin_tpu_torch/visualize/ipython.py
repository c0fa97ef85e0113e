"""Interactive Jupyter visualizers (turntable / first-person).

Counterpart of ``kaolin_tpu/visualize/ipython.py`` (reference
``kaolin/visualize/ipython.py``: quick_viz :50, update_canvas :113,
BaseIpyVisualizer :165, IpyTurntableVisualizer :446,
IpyFirstPersonVisualizer :719, quaternion helpers :352-429). The cameras
are :mod:`kaolin_tpu_torch.render.camera`'s, on the camera's device; the
quaternion helpers take tensors.

The widget stack (ipycanvas / ipyevents / ipywidgets) is imported lazily —
when absent, the visualizers still run headless (camera manipulation +
rendering callable through :meth:`_handle_event`, which is how the tests
drive them); only :meth:`show` requires the widgets.
"""

import math

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import _host

__all__ = [
    "quick_viz", "update_canvas", "BaseIpyVisualizer",
    "IpyTurntableVisualizer", "IpyFirstPersonVisualizer",
    "make_quaternion_rotation", "conjugate", "mulqv", "mulqq",
    "rotate_around_axis",
]


def quick_viz(imgs, nrow=None, inches=15):
    """Show a batch of images in a matplotlib grid. Ref :50."""
    import matplotlib.pyplot as plt
    imgs = [_host(im) for im in imgs]
    n = len(imgs)
    if nrow is None:
        nrow = int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    fig, axes = plt.subplots(ncol, nrow, squeeze=False,
                             figsize=(inches, inches * ncol / nrow))
    for i, ax_row in enumerate(axes):
        for j, ax in enumerate(ax_row):
            idx = i * nrow + j
            ax.axis("off")
            if idx < n:
                ax.imshow(imgs[idx])
    plt.show()
    return fig


def update_canvas(canvas, image, format="PNG", quality=100):
    """Draw an image (H, W, 3) uint8 onto an ipycanvas Canvas. Ref :113."""
    img = _host(image)
    if hasattr(canvas, "put_image_data"):
        canvas.put_image_data(img.astype(np.uint8), 0, 0)
    else:  # headless stub
        canvas.last_image = img


# -- quaternion helpers (ref :352-429), (x, y, z, w) layout like reference --

def make_quaternion_rotation(angle, vec):
    """Rotation quaternion (x, y, z, w) of ``angle`` around ``vec``, float32
    on ``vec``'s device. Ref :352."""
    vec = torch.as_tensor(vec, dtype=torch.float32)
    vec = vec / torch.linalg.vector_norm(vec)
    half = angle / 2.0
    return torch.cat([vec * math.sin(half),
                      torch.tensor([math.cos(half)], dtype=vec.dtype,
                                   device=vec.device)])


def conjugate(quat):
    """Ref :375."""
    return quat * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=quat.dtype,
                               device=quat.device)


def mulqq(l, r):
    """Hamilton product (x, y, z, w). Ref :408."""
    lx, ly, lz, lw = l
    rx, ry, rz, rw = r
    return torch.stack([
        lw * rx + lx * rw + ly * rz - lz * ry,
        lw * ry - lx * rz + ly * rw + lz * rx,
        lw * rz + lx * ry - ly * rx + lz * rw,
        lw * rw - lx * rx - ly * ry - lz * rz,
    ])


def mulqv(q, v):
    """Rotate vector v by quaternion q. Ref :387."""
    qv = torch.cat([torch.as_tensor(v, dtype=q.dtype, device=q.device),
                    torch.zeros((1,), dtype=q.dtype, device=q.device)])
    return mulqq(mulqq(q, qv), conjugate(q))[:3]


def rotate_around_axis(point, angle, axis):
    """Rotate ``point`` by ``angle`` around ``axis``. Ref :429."""
    return mulqv(make_quaternion_rotation(angle, axis), point)


class _HeadlessCanvas:
    """Minimal Canvas stand-in used when ipycanvas is unavailable."""

    def __init__(self, height, width):
        self.height = height
        self.width = width
        self.last_image = None


class BaseIpyVisualizer:
    """Canvas + event plumbing shared by the visualizers. Ref :165."""

    def __init__(self, height, width, camera, render, fast_render=None,
                 watched_events=None, max_fps=None, canvas=None,
                 event_canvas=None, img_format="PNG", img_quality=100):
        assert len(camera) == 1, "only single camera supported for visualizer"
        self.camera = camera
        self.render = render
        self.height = height
        self.width = width
        self.img_format = img_format
        self.img_quality = img_quality
        self.fast_render = render if fast_render is None else fast_render
        self._max_fps = max_fps
        self.current_output = None
        self.out = None

        if canvas is None:
            try:
                from ipycanvas import Canvas
                canvas = Canvas(height=height, width=width)
            except ImportError:
                canvas = _HeadlessCanvas(height, width)
        self.canvas = canvas
        self.event_canvas = canvas if event_canvas is None else event_canvas

        try:
            from ipyevents import Event
            from ipywidgets import Output
            self.out = Output()
            wait = 0 if max_fps is None else int(1000.0 / max_fps)
            self.event = Event(source=self.event_canvas,
                               watched_events=watched_events or [],
                               prevent_default_action=True, wait=wait)
            self.event.on_dom_event(self._handle_event)
        except ImportError:
            self.event = None

    def render_update(self):
        """Ref :277."""
        output = self.render(self.camera)
        if not isinstance(output, dict):
            output = {"img": output}
        self.current_output = output
        update_canvas(self.canvas, output["img"], format=self.img_format,
                      quality=self.img_quality)

    def fast_render_update(self):
        """Ref :290."""
        output = self.fast_render(self.camera)
        if isinstance(output, tuple):
            output = output[0]
        elif isinstance(output, dict):
            output = output["img"]
        update_canvas(self.canvas, output, format=self.img_format,
                      quality=self.img_quality)

    def show(self):
        """Display the canvas with interactive features. Ref :301."""
        if isinstance(self.canvas, _HeadlessCanvas):
            raise ImportError(
                "ipycanvas / ipyevents are required for interactive display")
        from IPython.display import display
        self.render_update()
        display(self.canvas, self.out)

    def _get_clamped_coords(self, event):
        sx = int(event["relativeX"] * self.canvas.width
                 / event["boundingRectWidth"])
        sy = int(event["relativeY"] * self.canvas.height
                 / event["boundingRectHeight"])
        return (min(max(sx, 0), self.canvas.width - 1),
                min(max(sy, 0), self.canvas.height - 1))

    def get_values_under_cursor(self, event):
        """Output values at the cursor pixel. Ref :323."""
        cx, cy = self._get_clamped_coords(event)
        res = {}
        if self.current_output is None:
            return res
        for key, item in self.current_output.items():
            arr = _host(item)
            if arr.ndim >= 2:
                y = int(cy * arr.shape[0] / self.canvas.height)
                x = int(cx * arr.shape[1] / self.canvas.width)
                res[key] = arr[y, x]
        return res

    @property
    def max_fps(self):
        return self._max_fps

    @max_fps.setter
    def max_fps(self, new_val):
        self._max_fps = new_val

    def _handle_event(self, event):
        raise NotImplementedError


def _set_fov_y(camera, new_fov_y_deg):
    """Rebuild pinhole intrinsics with a new vertical fov, preserving the
    fov_x/fov_y ratio (no distortion)."""
    from kaolin_tpu_torch.render.camera.intrinsics import CameraFOV
    intr = camera.intrinsics
    ratio = float(intr.fov(CameraFOV.HORIZONTAL)[0]) \
        / float(intr.fov(CameraFOV.VERTICAL)[0])
    new_fov_x = new_fov_y_deg * ratio
    focal_y = (intr.height / 2.0) / math.tan(math.radians(new_fov_y_deg) / 2)
    focal_x = (intr.width / 2.0) / math.tan(math.radians(new_fov_x) / 2)
    new_params = intr.params.clone()
    new_params[:, 2] = focal_x
    new_params[:, 3] = focal_y
    new_intr = intr.__class__(intr.width, intr.height, new_params,
                              near=intr.near, far=intr.far)
    from kaolin_tpu_torch.render.camera.camera import Camera
    return Camera(camera.extrinsics, new_intr)


class IpyTurntableVisualizer(BaseIpyVisualizer):
    """Turntable visualizer: left-drag orbits the focus point, wheel zooms
    (ctrl+wheel moves forward), right-drag translates. Ref :446."""

    def __init__(self, height, width, camera, render, fast_render=None,
                 focus_at=None, world_up_axis=1, zoom_sensitivity=1e-3,
                 forward_sensitivity=1e-3, rotation_sensitivity=1.5,
                 translation_sensitivity=1.0, max_fps=24.0,
                 update_only_on_release=False,
                 additional_watched_events=None,
                 additional_event_handler=None, canvas=None,
                 event_canvas=None, img_format="PNG", img_quality=100):
        from kaolin_tpu_torch.ops.coords import cartesian2spherical
        from kaolin_tpu_torch.render.camera.camera import Camera
        from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics

        if focus_at is None:
            focus_at = torch.zeros((3,))
        self.focus_at = torch.as_tensor(focus_at, dtype=torch.float32,
                                        device=camera.device)
        vec = self.focus_at - camera.cam_pos().squeeze()
        if world_up_axis == 0:
            z, x, y = vec
        elif world_up_axis == 1:
            y, z, x = vec
        else:
            x, y, z = vec
        az, el, dist = cartesian2spherical(x, y, z)
        self.azimuth = float(az)
        self.elevation = float(el)
        self.distance = torch.tensor(float(dist), device=camera.device)

        self.up_sign = float(
            camera.cam_up().squeeze()[world_up_axis] >= 0) * 2.0 - 1.0
        up = np.zeros((3,), dtype=np.float32)
        up[world_up_axis] = self.up_sign
        extr = CameraExtrinsics.from_lookat(
            eye=camera.cam_pos().squeeze(), at=self.focus_at, up=up,
            dtype=camera.dtype, device=camera.device)
        camera = Camera(extr, camera.intrinsics)

        self.position = None
        self.world_up_axis = world_up_axis
        self.zoom_sensitivity = zoom_sensitivity
        self.forward_sensitivity = forward_sensitivity
        self.rotation_scale = rotation_sensitivity * math.pi
        self.translation_sensitivity = translation_sensitivity
        self.update_only_on_release = update_only_on_release
        self.additional_event_handler = additional_event_handler

        watched = ["wheel", "mousedown", "mouseup", "mousemove",
                   "mouseleave", "mouseenter", "contextmenu"]
        if additional_watched_events:
            watched += additional_watched_events
        super().__init__(height, width, camera, render, fast_render, watched,
                         max_fps, canvas=canvas, event_canvas=event_canvas,
                         img_format=img_format, img_quality=img_quality)

    def _make_camera(self):
        """Rebuild extrinsics from (azimuth, elevation, distance). Ref :596."""
        from kaolin_tpu_torch.ops.coords import spherical2cartesian
        from kaolin_tpu_torch.render.camera.camera import Camera
        from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics
        device = self.distance.device
        comps = spherical2cartesian(torch.tensor(self.azimuth, device=device),
                                    torch.tensor(self.elevation,
                                                 device=device),
                                    self.distance)
        if self.world_up_axis == 0:
            y, z, x = comps
        elif self.world_up_axis == 1:
            z, x, y = comps
        else:
            x, y, z = comps
        eye = self.focus_at - torch.stack([x, y, z]).reshape(3)
        up = np.zeros((3,), dtype=np.float32)
        up[self.world_up_axis] = self.up_sign
        extr = CameraExtrinsics.from_lookat(eye=eye, at=self.focus_at, up=up,
                                            dtype=self.camera.dtype,
                                            device=self.camera.device)
        self.camera = Camera(extr, self.camera.intrinsics)

    def _move_translation(self, amount_up, amount_left):
        """Pan camera + focus point. Ref :617."""
        from kaolin_tpu_torch.render.camera.camera import Camera
        old_pos = self.camera.cam_pos()
        extr = self.camera.extrinsics.move_up(amount_up) \
            .move_right(-amount_left)
        self.camera = Camera(extr, self.camera.intrinsics)
        self.focus_at = self.focus_at + (
            self.camera.cam_pos() - old_pos).squeeze()

    def _move_turntable(self, amount_elevation, amount_azimuth):
        """Orbit with pole crossing. Ref :627."""
        self.elevation -= amount_elevation * self.up_sign
        self.azimuth -= amount_azimuth * self.up_sign
        if self.elevation > math.pi / 2.0:
            self.elevation = math.pi - self.elevation
            self.up_sign = -self.up_sign
            self.azimuth += math.pi
        if self.elevation < -math.pi / 2.0:
            self.elevation = -math.pi - self.elevation
            self.up_sign = -self.up_sign
            self.azimuth += math.pi
        self._make_camera()

    def _safe_zoom(self, amount):
        """Sigmoid-constrained fov zoom. Ref :675."""
        from kaolin_tpu_torch.render.camera.intrinsics import CameraFOV
        fov_y = float(self.camera.intrinsics.fov(CameraFOV.VERTICAL)[0])
        coeff = fov_y / 180.0
        inv = math.log(coeff / (1 - coeff))
        new_fov_y = 180.0 / (1 + math.exp(-(inv + amount)))
        self.camera = _set_fov_y(self.camera, new_fov_y)

    def _safe_forward(self, amount):
        """Log-constrained dolly. Ref :697."""
        from kaolin_tpu_torch.render.camera.camera import Camera
        new_distance = torch.exp(torch.log(self.distance) + amount)
        extr = self.camera.extrinsics.move_forward(
            float(new_distance - self.distance))
        self.camera = Camera(extr, self.camera.intrinsics)
        self.distance = new_distance

    def _handle_event(self, event):
        """Ref :707."""
        if self.additional_event_handler is not None:
            if not self.additional_event_handler(self, event):
                return
        etype = event["type"]
        if etype == "wheel":
            if event.get("ctrlKey"):
                self._safe_forward(event["deltaY"] * self.forward_sensitivity)
            else:
                self._safe_zoom(event["deltaY"] * self.zoom_sensitivity)
            self.render_update()
        elif etype == "mousedown":
            self.position = (event["relativeX"], event["relativeY"])
        elif etype in ("mouseup", "mouseleave", "mouseenter"):
            self.render_update()
        elif etype == "mousemove" and self.position is not None:
            dx_px = event["relativeX"] - self.position[0]
            dy_px = event["relativeY"] - self.position[1]
            if event.get("buttons") == 1:
                dx = self.rotation_scale * dx_px / self.canvas.width
                dy = self.rotation_scale * dy_px / self.canvas.height
                self._move_turntable(dy, dx)
            elif event.get("buttons") == 2:
                dx = self.translation_sensitivity * dx_px / self.canvas.width
                dy = self.translation_sensitivity * dy_px / self.canvas.height
                self._move_translation(dy, dx)
            else:
                return
            self.position = (event["relativeX"], event["relativeY"])
            if not self.update_only_on_release:
                self.fast_render_update()


class IpyFirstPersonVisualizer(BaseIpyVisualizer):
    """First-person visualizer: drag looks around (elevation clamped at the
    poles), keys move, wheel zooms. Ref :719."""

    def __init__(self, height, width, camera, render, fast_render=None,
                 world_up=None, zoom_sensitivity=1e-3,
                 rotation_sensitivity=0.4, key_move_sensitivity=0.05,
                 max_fps=24.0, update_only_on_release=False,
                 additional_watched_events=None,
                 additional_event_handler=None, up_key="i", down_key="k",
                 left_key="j", right_key="l", forward_key="o",
                 backward_key="u", canvas=None, event_canvas=None,
                 img_format="PNG", img_quality=100):
        from kaolin_tpu_torch.render.camera.camera import Camera
        from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics

        if world_up is None:
            self.world_up = camera.cam_up().squeeze()
            self.elevation = 0.0
        else:
            self.world_up = torch.as_tensor(
                world_up, dtype=torch.float32, device=camera.device
            ).reshape(3)
            self.world_up = self.world_up / torch.linalg.vector_norm(
                self.world_up)
            extr = CameraExtrinsics.from_lookat(
                eye=camera.cam_pos().squeeze(),
                at=(camera.cam_pos() - camera.cam_forward()).squeeze(),
                up=self.world_up, dtype=camera.dtype, device=camera.device)
            camera = Camera(extr, camera.intrinsics)
            cosang = float(torch.clip(torch.dot(
                self.world_up, camera.cam_up().squeeze()), -1.0, 1.0))
            self.elevation = math.acos(cosang)
            if float(torch.dot(self.world_up,
                               camera.cam_forward().squeeze())) >= 0:
                self.elevation = -self.elevation
        self.azimuth = 0.0
        self.zoom_sensitivity = zoom_sensitivity
        self.rotation_scale = rotation_sensitivity * math.pi
        self.key_move_sensitivity = key_move_sensitivity
        self.update_only_on_release = update_only_on_release
        self.additional_event_handler = additional_event_handler
        self.position = None
        self._key_moves = {
            up_key: (1, 1.0), down_key: (1, -1.0),
            right_key: (0, 1.0), left_key: (0, -1.0),
            forward_key: (2, 1.0), backward_key: (2, -1.0),
        }

        watched = ["wheel", "mousedown", "mouseup", "mousemove", "mouseleave",
                   "mouseenter", "keydown", "contextmenu"]
        if additional_watched_events:
            watched += additional_watched_events
        super().__init__(height, width, camera, render, fast_render, watched,
                         max_fps, canvas=canvas, event_canvas=event_canvas,
                         img_format=img_format, img_quality=img_quality)

    _safe_zoom = IpyTurntableVisualizer._safe_zoom

    def _rotate(self, d_azimuth, d_elevation):
        """Look around; clamp elevation to avoid flipping over the poles."""
        from kaolin_tpu_torch.render.camera.camera import Camera
        new_elevation = self.elevation + d_elevation
        clamped = min(max(new_elevation, -math.pi / 2 + 1e-3),
                      math.pi / 2 - 1e-3)
        self.elevation = clamped
        self.azimuth += d_azimuth
        extr = self.camera.extrinsics
        pos = extr.cam_pos().squeeze()
        # state-based rebuild (no incremental double-counting): take the
        # current viewing direction (cam_forward points from the target
        # TOWARD the camera — reference convention), strip its vertical
        # component, yaw it around world up, then pitch by the full
        # tracked elevation
        view_dir = -extr.cam_forward().squeeze()
        up = self.world_up.to(self.camera.dtype)
        horiz = view_dir - torch.dot(up, view_dir) * up
        norm = float(torch.linalg.vector_norm(horiz))
        if norm < 1e-6:  # looking straight up/down: keep previous azimuth ref
            horiz = -extr.cam_up().squeeze() * torch.sign(
                torch.dot(up, view_dir))
            horiz = horiz - torch.dot(up, horiz) * up
        horiz = horiz / torch.linalg.vector_norm(horiz)
        horiz = rotate_around_axis(horiz, -d_azimuth, self.world_up)
        from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics
        extr = CameraExtrinsics.from_lookat(
            eye=pos, at=pos + horiz, up=up, dtype=self.camera.dtype,
            device=self.camera.device).rotate(pitch=self.elevation)
        self.camera = Camera(extr, self.camera.intrinsics)

    def _move(self, axis, sign):
        from kaolin_tpu_torch.render.camera.camera import Camera
        amount = sign * self.key_move_sensitivity
        extr = self.camera.extrinsics
        extr = (extr.move_right(amount) if axis == 0 else
                extr.move_up(amount) if axis == 1 else
                extr.move_forward(amount))
        self.camera = Camera(extr, self.camera.intrinsics)

    def _handle_event(self, event):
        if self.additional_event_handler is not None:
            if not self.additional_event_handler(self, event):
                return
        etype = event["type"]
        if etype == "wheel":
            self._safe_zoom(event["deltaY"] * self.zoom_sensitivity)
            self.render_update()
        elif etype == "keydown":
            key = event.get("key")
            if key in self._key_moves:
                self._move(*self._key_moves[key])
                self.fast_render_update()
        elif etype == "mousedown":
            self.position = (event["relativeX"], event["relativeY"])
        elif etype in ("mouseup", "mouseleave", "mouseenter"):
            self.render_update()
        elif etype == "mousemove" and self.position is not None \
                and event.get("buttons") == 1:
            dx = self.rotation_scale * (
                event["relativeX"] - self.position[0]) / self.canvas.width
            dy = self.rotation_scale * (
                event["relativeY"] - self.position[1]) / self.canvas.height
            self._rotate(dx, -dy)
            self.position = (event["relativeX"], event["relativeY"])
            if not self.update_only_on_release:
                self.fast_render_update()
