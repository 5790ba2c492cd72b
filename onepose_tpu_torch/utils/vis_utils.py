"""Visualization for the port: the demo's frame rendering (``reproj``,
``draw_3d_box``, ``draw_2d_box``, ``save_demo_image``, ``make_video``),
training's match figures (``draw_matches``), and the scene exports: PLY +
JSON (``export_scene``), one self-contained HTML file with an interactive
3D view of an object's points and the estimated cameras
(``export_scene_html``), and the optional per-frame wis3d dump
(``dump_wis3d``).

The port's own copy of ``onepose_tpu/utils/vis_utils.py``; cv2, PIL and
wis3d are imported inside the functions that use them.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np


# 12 edges of a box given the reference corner ordering (bottom 0-3, top 4-7)
BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def reproj(K: np.ndarray, pose: np.ndarray, pts3d: np.ndarray) -> np.ndarray:
    """Project [n,3] object points with 3x4/4x4 pose → [n,2] pixels."""
    pose = np.asarray(pose, np.float64)
    R, t = pose[:3, :3], pose[:3, 3]
    cam = np.asarray(pts3d) @ R.T + t
    uv = cam @ np.asarray(K).T
    return uv[:, :2] / uv[:, 2:3]


def draw_3d_box(image: np.ndarray, corners_2d: np.ndarray,
                color=(0, 0, 255), thickness: int = 2) -> np.ndarray:
    """Draw the projected 3D box wireframe on a BGR image (in place)."""
    import cv2

    c = np.asarray(corners_2d).astype(int)
    for a, b in BOX_EDGES:
        cv2.line(image, tuple(c[a]), tuple(c[b]), color, thickness)
    return image


def draw_2d_box(image: np.ndarray, bbox, color=(0, 255, 0),
                thickness: int = 2) -> np.ndarray:
    """Draw the box (x0, y0, x1, y1) on a BGR image (in place)."""
    import cv2

    x0, y0, x1, y1 = [int(v) for v in bbox]
    cv2.rectangle(image, (x0, y0), (x1, y1), color, thickness)
    return image


def save_demo_image(pose_pred: np.ndarray, K: np.ndarray,
                    image: np.ndarray, box3d_corners: np.ndarray,
                    draw_box: bool, save_path: str) -> np.ndarray:
    """Overlay the estimated 3D box on a frame and write it."""
    import cv2

    img = image.copy()
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if draw_box and pose_pred is not None:
        corners_2d = reproj(K, pose_pred, box3d_corners)
        draw_3d_box(img, corners_2d)
    os.makedirs(osp.dirname(save_path) or ".", exist_ok=True)
    cv2.imwrite(save_path, img)
    return img


def draw_matches(img0: np.ndarray, kpts0: np.ndarray, img1: np.ndarray,
                 kpts1: np.ndarray, confidence: Optional[np.ndarray] = None,
                 save_path: Optional[str] = None) -> np.ndarray:
    """Side-by-side match visualization with confidence-colored lines."""
    import cv2

    def to_bgr(im):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        if im.ndim == 2:
            im = cv2.cvtColor(im, cv2.COLOR_GRAY2BGR)
        return im

    im0, im1 = to_bgr(img0), to_bgr(img1)
    h = max(im0.shape[0], im1.shape[0])
    canvas = np.zeros((h, im0.shape[1] + im1.shape[1], 3), np.uint8)
    canvas[: im0.shape[0], : im0.shape[1]] = im0
    canvas[: im1.shape[0], im0.shape[1]:] = im1
    off = im0.shape[1]
    conf = confidence if confidence is not None else np.ones(len(kpts0))
    for (x0, y0), (x1, y1), c in zip(
            np.asarray(kpts0), np.asarray(kpts1), conf):
        col = (0, int(255 * float(c)), int(255 * (1 - float(c))))
        cv2.line(canvas, (int(x0), int(y0)), (int(x1) + off, int(y1)),
                 col, 1)
    if save_path:
        os.makedirs(osp.dirname(save_path) or ".", exist_ok=True)
        cv2.imwrite(save_path, canvas)
    return canvas


def make_video(image_dir: str, output_path: str, fps: int = 24):
    """Assemble numbered PNGs into an mp4."""
    import cv2
    import glob

    frames = sorted(
        glob.glob(osp.join(image_dir, "*.png")),
        key=lambda p: int(osp.splitext(osp.basename(p))[0]))
    if not frames:
        return None
    first = cv2.imread(frames[0])
    h, w = first.shape[:2]
    os.makedirs(osp.dirname(output_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for p in frames:
        writer.write(cv2.imread(p))
    writer.release()
    return output_path


def export_scene(out_dir: str, points3d: Optional[np.ndarray] = None,
                 poses: Optional[Sequence[np.ndarray]] = None,
                 K: Optional[np.ndarray] = None,
                 box3d_corners: Optional[np.ndarray] = None,
                 name: str = "scene"):
    """Export a reconstruction (point cloud, cameras, 3D box) as an ASCII
    PLY of the points and a JSON manifest, for external viewers. Returns
    the manifest's path."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"name": name}
    if points3d is not None:
        ply_path = osp.join(out_dir, f"{name}_points.ply")
        pts = np.asarray(points3d)
        with open(ply_path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(pts)}\n")
            f.write("property float x\nproperty float y\n"
                    "property float z\nend_header\n")
            for x, y, z in pts:
                f.write(f"{x} {y} {z}\n")
        manifest["points"] = ply_path
    if poses is not None:
        cams = []
        for pose in poses:
            pose = np.asarray(pose)
            R, t = pose[:3, :3], pose[:3, 3]
            cams.append({
                "R": R.tolist(), "t": t.tolist(),
                "center": (-R.T @ t).tolist(),
            })
        manifest["cameras"] = cams
    if K is not None:
        manifest["K"] = np.asarray(K).tolist()
    if box3d_corners is not None:
        manifest["box3d_corners"] = np.asarray(box3d_corners).tolist()
    json_path = osp.join(out_dir, f"{name}.json")
    with open(json_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return json_path


_SCENE_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title><style>
 body{{margin:0;background:#111;color:#ccc;font:12px monospace}}
 #hud{{position:fixed;top:8px;left:8px}}</style></head>
<body><canvas id="c"></canvas><div id="hud">{title} —
 drag: orbit · wheel: zoom · shift-drag: pan</div>
<script>
const SCENE = {scene_json};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let yaw=0.6, pitch=0.4, dist=2.5, cx=0, cy=0, panx=0, pany=0;
const pts = SCENE.points || [];
let ctr=[0,0,0];
if (pts.length) {{
  for (const p of pts) {{ctr[0]+=p[0];ctr[1]+=p[1];ctr[2]+=p[2];}}
  ctr = ctr.map(v=>v/pts.length);
  let r=0; for (const p of pts) r=Math.max(r,Math.hypot(
    p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]));
  dist = Math.max(r*3, 1e-3);
}}
function proj(p) {{
  const x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const cy_=Math.cos(yaw), sy=Math.sin(yaw),
        cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1=cy_*x+sy*z, z1=-sy*x+cy_*z;
  const y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
  if (z2<=1e-6) return null;
  const f=0.9*Math.min(cv.width,cv.height);
  return [cv.width/2+f*x1/z2+panx, cv.height/2-f*y2/z2+pany, z2];
}}
function seg(a,b,style) {{
  const pa=proj(a), pb=proj(b); if(!pa||!pb) return;
  ctx.strokeStyle=style; ctx.beginPath();
  ctx.moveTo(pa[0],pa[1]); ctx.lineTo(pb[0],pb[1]); ctx.stroke();
}}
const BOX_EDGES=[[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
                 [0,4],[1,5],[2,6],[3,7]];
function draw() {{
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.fillStyle="#111"; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.fillStyle="#7fd0ff";
  for (const p of pts) {{
    const q=proj(p); if(!q) continue;
    const s=Math.max(1, 3-q[2]/dist);
    ctx.fillRect(q[0],q[1],s,s);
  }}
  if (SCENE.box3d_corners)
    for (const e of BOX_EDGES)
      seg(SCENE.box3d_corners[e[0]], SCENE.box3d_corners[e[1]],"#ffd24d");
  for (const cam of SCENE.cameras||[]) {{
    const C=cam.center, R=cam.R, s=dist*0.04;
    const colors=["#ff6b6b","#6bff7f","#6b8cff"];
    for (let k=0;k<3;k++) {{
      // cam.R columns are the camera axes in world coords
      const dir=[R[0][k],R[1][k],R[2][k]];
      seg(C,[C[0]+s*dir[0],C[1]+s*dir[1],C[2]+s*dir[2]],colors[k]);
    }}
  }}
}}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{{if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){{panx+=dx;pany+=dy;}}
  else{{yaw+=dx*0.01;pitch+=dy*0.01;
    pitch=Math.max(-1.55,Math.min(1.55,pitch));}}
  drag=[e.clientX,e.clientY,drag[2]]; draw();}};
onwheel=e=>{{dist*=Math.exp(e.deltaY*0.001); draw();}};
onresize=draw; draw();
</script></body></html>
"""


def export_scene_html(out_path: str,
                      points3d: Optional[np.ndarray] = None,
                      poses: Optional[Sequence[np.ndarray]] = None,
                      box3d_corners: Optional[np.ndarray] = None,
                      name: str = "scene",
                      max_points: int = 20000) -> str:
    """Write a single self-contained HTML file with an interactive 3D view
    of the reconstruction (orbit/zoom/pan; points + camera axes + 3D box).

    The scene JSON is embedded in a small vanilla-JS canvas viewer: open
    the file in any browser.
    """
    scene = {}
    if points3d is not None:
        pts = np.asarray(points3d, np.float32)
        if len(pts) > max_points:
            pts = pts[np.linspace(0, len(pts) - 1, max_points).astype(int)]
        scene["points"] = np.round(pts, 5).tolist()
    if poses is not None:
        cams = []
        for pose in poses:
            pose = np.asarray(pose, np.float64)
            R, t = pose[:3, :3], pose[:3, 3]
            cams.append({"R": R.T.round(5).tolist(),  # cam→world axes
                         "center": (-R.T @ t).round(5).tolist()})
        scene["cameras"] = cams
    if box3d_corners is not None:
        scene["box3d_corners"] = np.asarray(
            box3d_corners, np.float64).round(5).tolist()

    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    html = _SCENE_HTML.format(title=name, scene_json=json.dumps(scene))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def dump_wis3d(idx: int, vis_dir: str, seq_name: str,
               image0, image1, image_full,
               kpts2d: np.ndarray, kpts2d_reproj: np.ndarray,
               confidence: np.ndarray,
               inliers: Optional[np.ndarray] = None):
    """One wis3d scene for frame ``idx``: the query↔reprojected keypoint
    correspondences (confidence, reprojection distance, inlier flags) and
    the rendered full-resolution result, when the optional wis3d package
    is importable; a printed skip otherwise.

    ``image0``/``image1``: grayscale or RGB arrays (or PIL images);
    ``image_full``: a BGR uint8 render (cv2's order, as the demo writes);
    ``inliers``: indices into kpts2d, or None. Returns the Wis3D handle,
    or None when wis3d is absent.
    """
    try:
        from wis3d import Wis3D
    except ImportError:
        print("[vis] wis3d not available; skipping interactive dump")
        return None

    kpts2d = np.asarray(kpts2d, np.float64).reshape(-1, 2)
    kpts2d_reproj = np.asarray(kpts2d_reproj, np.float64).reshape(-1, 2)
    confidence = np.asarray(confidence, np.float64).reshape(-1)
    reproj_distance = np.linalg.norm(kpts2d_reproj - kpts2d, axis=1)
    inlier_flags = np.zeros((kpts2d.shape[0], 1), dtype=bool)
    if inliers is not None:
        inlier_flags[np.asarray(inliers, np.int64)] = True
    n_inliers = int(inlier_flags.sum())

    def as_pil(img, bgr=False):
        try:
            from PIL import Image
        except ImportError:
            return img
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255 if arr.max() <= 1.0 + 1e-6 else arr,
                          0, 255).astype(np.uint8)
        if bgr and arr.ndim == 3:
            arr = arr[..., ::-1]
        return Image.fromarray(arr)

    img0 = as_pil(image0)
    img1 = as_pil(image1)
    w, h = getattr(img0, "size", (np.asarray(image0).shape[1],
                                  np.asarray(image0).shape[0]))

    vis = Wis3D(vis_dir, seq_name)
    vis.set_scene_id(idx)
    vis.add_keypoint_correspondences(
        img0, img1, kpts2d, kpts2d_reproj,
        metrics={"mconf": confidence.tolist(),
                 "reproj_distance": reproj_distance.tolist()},
        booleans={"inliers": inlier_flags.tolist()},
        meta={"num_inliers": n_inliers, "width": w, "height": h},
        name="matches")
    if image_full is not None:
        vis.add_image(as_pil(image_full, bgr=True), name="results")
    return vis
