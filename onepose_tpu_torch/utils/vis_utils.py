"""Scene export for the port: one self-contained HTML file with an
interactive 3D view of an object's points and the estimated cameras.

The port's own copy of ``export_scene_html`` (and its page template) from
``onepose_tpu/utils/vis_utils.py``.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np


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
