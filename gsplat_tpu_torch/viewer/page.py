"""Single-page viewer client (orbit controls + render settings panel).

Port of `gsplat_tpu/viewer/page.py`, served by viewer/core.py; talks JSON
to /render, /state, /info and shows whatever image each /render returns
(PNG here).  The control set mirrors upstream gsplat's viewer GUI folders.
"""

HTML_PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>gsplat_tpu_torch viewer</title>
<style>
  body { margin:0; background:#111; color:#ddd; font:13px sans-serif;
         overflow:hidden; }
  #view { position:absolute; inset:0; width:100%; height:100%;
          cursor:grab; }
  #panel { position:absolute; top:10px; right:10px; width:240px;
           background:#1c1c1cee; border:1px solid #333; border-radius:8px;
           padding:10px 12px; }
  #panel h3 { margin:4px 0 8px; font-size:13px; color:#fff; }
  .row { display:flex; justify-content:space-between; align-items:center;
         margin:5px 0; gap:6px; }
  .row label { flex:1; }
  .row input[type=number] { width:64px; background:#222; color:#ddd;
         border:1px solid #444; border-radius:4px; padding:2px 4px; }
  .row input[type=range] { width:110px; }
  .row select { background:#222; color:#ddd; border:1px solid #444;
         border-radius:4px; }
  #stats { color:#8bc; margin-top:6px; white-space:pre-line; }
  button { background:#2a4; color:#fff; border:0; border-radius:4px;
           padding:4px 10px; cursor:pointer; }
  button.paused { background:#a42; }
</style>
</head>
<body>
<img id="view" draggable="false"/>
<div id="panel">
  <h3>gsplat_tpu_torch viewer</h3>
  <div class="row"><label>Render mode</label>
    <select id="render_mode"></select></div>
  <div class="row"><label>Colormap</label>
    <select id="colormap"></select></div>
  <div class="row"><label>Max SH</label>
    <input type="number" id="max_sh_degree" min="0" max="5" step="1"/></div>
  <div class="row"><label>Near</label>
    <input type="number" id="near_plane" step="0.01"/></div>
  <div class="row"><label>Far</label>
    <input type="number" id="far_plane" step="1"/></div>
  <div class="row"><label>Radius clip</label>
    <input type="number" id="radius_clip" step="0.1"/></div>
  <div class="row"><label>eps2d</label>
    <input type="number" id="eps2d" step="0.05"/></div>
  <div class="row"><label>Max res</label>
    <input type="number" id="viewer_res" min="64" max="2160" step="108"/></div>
  <div class="row"><label>Normalize near/far</label>
    <input type="checkbox" id="normalize_nearfar"/></div>
  <div class="row"><label>Inverse depth</label>
    <input type="checkbox" id="inverse"/></div>
  <div class="row"><label>Background</label>
    <input type="color" id="bg" value="#000000"/></div>
  <div class="row" id="trainrow" style="display:none">
    <button id="pause">Pause training</button></div>
  <div id="stats"></div>
</div>
<script>
"use strict";
// --- camera state: orbit around a target ---
let target = [0, 0, 0];
let radius = 4.0, theta = 0.0, phi = 1.2;   // spherical (y-up-ish)
let fov = 50 * Math.PI / 180;
let dragging = 0, lastX = 0, lastY = 0, moving = false, inflight = false;
let pending = false, info = null;

function c2wMatrix() {
  // OpenCV convention: +z forward (into the scene), +y down.
  const ct = Math.cos(theta), st = Math.sin(theta);
  const cp = Math.cos(phi), sp = Math.sin(phi);
  const eye = [target[0] + radius * sp * st,
               target[1] + radius * cp,
               target[2] + radius * sp * ct];
  let f = norm3(sub3(target, eye));          // forward = +z
  let upW = [0, -1, 0];                       // world up (OpenCV y-down)
  let r = norm3(cross3(f, upW));              // right = +x
  if (!isFinite(r[0])) r = [1, 0, 0];
  const d = cross3(f, r);                     // down = +y
  return [r[0], d[0], f[0], eye[0],
          r[1], d[1], f[1], eye[1],
          r[2], d[2], f[2], eye[2],
          0, 0, 0, 1];
}
const sub3 = (a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
const cross3=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
function norm3(a){const n=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/n,a[1]/n,a[2]/n];}

async function render() {
  if (inflight) { pending = true; return; }
  inflight = true;
  const scale = moving ? 0.4 : 1.0;
  const w = Math.round(innerWidth * scale), h = Math.round(innerHeight * scale);
  try {
    const r = await fetch("/render", {method: "POST", body: JSON.stringify(
      {c2w: c2wMatrix(), fov: fov, width: w, height: h})});
    if (r.ok) {
      const blob = await r.blob();
      const url = URL.createObjectURL(blob);
      const img = document.getElementById("view");
      const old = img.src;
      img.src = url;
      if (old) URL.revokeObjectURL(old);
    }
  } finally {
    inflight = false;
    if (pending) { pending = false; render(); }
  }
}

const view = document.getElementById("view");
view.addEventListener("mousedown", e => {
  dragging = e.button === 0 && !e.shiftKey ? 1 : 2;
  lastX = e.clientX; lastY = e.clientY; moving = true;
});
addEventListener("mouseup", () => { dragging = 0; moving = false; render(); });
addEventListener("mousemove", e => {
  if (!dragging) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  if (dragging === 1) {
    theta -= dx * 0.005;
    phi = Math.min(Math.PI - 0.05, Math.max(0.05, phi - dy * 0.005));
  } else {   // pan in camera plane
    const m = c2wMatrix();
    const s = radius * 0.0015;
    target[0] -= (m[0]*dx - m[1]*dy) * s;
    target[1] -= (m[4]*dx - m[5]*dy) * s;
    target[2] -= (m[8]*dx - m[9]*dy) * s;
  }
  render();
});
view.addEventListener("contextmenu", e => e.preventDefault());
addEventListener("wheel", e => {
  radius *= Math.exp(e.deltaY * 0.001);
  moving = true; render();
  clearTimeout(window._wt);
  window._wt = setTimeout(() => { moving = false; render(); }, 150);
});
addEventListener("keydown", e => {
  const m = c2wMatrix(), s = radius * 0.05;
  const mv = {w:[m[2],m[6],m[10]], s:[-m[2],-m[6],-m[10]],
              a:[-m[0],-m[4],-m[8]], d:[m[0],m[4],m[8]],
              q:[-m[1],-m[5],-m[9]], e:[m[1],m[5],m[9]]}[e.key];
  if (mv) {
    target[0]+=mv[0]*s; target[1]+=mv[1]*s; target[2]+=mv[2]*s; render();
  }
});
addEventListener("resize", render);

// --- settings panel ---
const FIELDS = ["max_sh_degree","near_plane","far_plane","radius_clip",
                "eps2d","viewer_res"];
async function pushState(upd) {
  await fetch("/state", {method:"POST", body: JSON.stringify(upd)});
  render();
}
function hookInputs() {
  for (const f of FIELDS) {
    document.getElementById(f).addEventListener("change", e =>
      pushState({[f]: parseFloat(e.target.value)}));
  }
  for (const f of ["normalize_nearfar","inverse"]) {
    document.getElementById(f).addEventListener("change", e =>
      pushState({[f]: e.target.checked}));
  }
  for (const f of ["render_mode","colormap"]) {
    document.getElementById(f).addEventListener("change", e =>
      pushState({[f]: e.target.value}));
  }
  document.getElementById("bg").addEventListener("change", e => {
    const v = e.target.value;
    pushState({backgrounds: [parseInt(v.slice(1,3),16)/255,
                             parseInt(v.slice(3,5),16)/255,
                             parseInt(v.slice(5,7),16)/255]});
  });
  document.getElementById("pause").addEventListener("click", async e => {
    const paused = !e.target.classList.contains("paused");
    e.target.classList.toggle("paused", paused);
    e.target.textContent = paused ? "Resume training" : "Pause training";
    await pushState({paused: paused});
  });
}
async function refreshInfo() {
  const r = await fetch("/info");
  info = await r.json();
  for (const sel of ["render_mode","colormap"]) {
    const el = document.getElementById(sel);
    if (!el.options.length) {
      const opts = sel === "render_mode" ? info.render_modes : info.colormaps;
      for (const o of opts) el.add(new Option(o, o));
    }
    el.value = info[sel];
  }
  for (const f of FIELDS) document.getElementById(f).value = info[f];
  document.getElementById("normalize_nearfar").checked = info.normalize_nearfar;
  document.getElementById("inverse").checked = info.inverse;
  document.getElementById("trainrow").style.display =
    info.mode === "training" ? "flex" : "none";
  let s = `splats: ${info.total_gs_count.toLocaleString()}`;
  if (info.mode === "training")
    s += `\nstep ${info.step}  (${info.steps_per_sec} it/s)`;
  document.getElementById("stats").textContent = s;
}
hookInputs();
refreshInfo().then(render);
setInterval(refreshInfo, 2000);
// live refresh while training
setInterval(() => { if (info && info.mode === "training" && !moving) render(); }, 3000);
</script>
</body>
</html>
"""
