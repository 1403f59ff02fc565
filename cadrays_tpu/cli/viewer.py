"""Live progressive viewer: browser-based, zero dependencies.

The reference's viewer is a desktop GLFW/ImGui app whose load-bearing
behavior is: render progressive passes continuously, show the refining
image, restart accumulation on any scene/camera/param edit
(AppViewer.cxx:979-984), accept commands in a console, orbit the camera
with the mouse (OrbitControls.cxx:70-158), select objects by click to
edit their material (AppGui.cxx onSelectionEvent), and pause/resume the
progressive loop (AppViewer.cxx:916-920). The ~25 kLoC vendored ImGui
layer is explicitly not worth rebuilding (SURVEY.md §7.1 step 9); this
page covers its function.

    python -m cadrays_tpu.cli.viewer scene.crt [--port 8790] [--res 512]

Serves:
  GET  /           viewer page (live image + console + mouse controls)
  GET  /frame.png  current tone-mapped accumulation
  GET  /status     JSON {spp, width, height, mode, paused}
  POST /exec       body = command line; executes on the session (edits
                   invalidate the accumulator via the state fingerprint)
  POST /orbit      JSON {op: rotate|pan|zoom, dx, dy} — mutates the
                   camera via cli/controls.OrbitControls; accumulation
                   restarts automatically (camera is in the fingerprint)
  POST /pick       JSON {x, y} in image pixels — returns the vpick line
                   (hit node name + position) for the selection flow
  POST /pause      toggles the progressive loop; returns "paused"/"running"
  GET  /tree       JSON scene tree (both roots, nested name/visible) —
                   the DataModelWidget panel data
  POST /node       JSON {name, op: show|hide|toggle} — per-node eye
                   (DataModelWidget.cxx:246-264)
  GET  /material?name=N  JSON BSDF lobes + Fresnels + preset class
                   (MaterialEditor.cxx:350-370)
  POST /material   JSON {name, kd|ks|kt|kc|le|baseRoughness|...|
                   baseFresnel:{type,params}} or {name, preset} —
                   executes as vbsdf/vsetmaterial (panel edits share the
                   command path's validation + restart fingerprint)
  GET  /transform?names=a,b  JSON numeric TRS fields: single select =
                   decomposed local translation/Euler/scale (absolute),
                   multi = common bbox-center anchor + zero deltas
                   (TransformWidget.cxx:112-246)
  POST /transform  JSON {names, translation, rotation_deg, scale,
                   reset?} — recompose (single) or delta-about-anchor
                   (multi)
  GET  /lights     JSON light list (LightSourcesEditor panel data)
  POST /light      JSON {op: add|del|clone|change, ...} over vlight
  GET  /settings   JSON render settings (SettingsWidget panel data)
  POST /settings   JSON {mode|ray_depth|clamp|width|height|fovy|
                   two_sided|coherent|adaptive|adaptive_debug|
                   persistent} -> vrenderparams/vrtsize/vcamera lines
  GET  /scripts    JSON list of *.crt/*.tcl script names in the session
                   script dir (ScriptEditor.cxx:48-64)
  GET  /script?name=N  script source
  POST /script     JSON {name, text[, run]} — save (and optionally run)
                   the script (ScriptEditor.cxx:134-263)
  POST /script_delete  JSON {name}

Mouse on the image: drag = orbit, shift-drag = pan, wheel = zoom,
click = pick (fills the command box with `vbsdf <name> ` ready to edit).

The render loop runs in the main thread; HTTP handling in a daemon
thread. This is deliberately simple — the command surface does the rest.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>cadrays_tpu viewer</title><style>
body { background:#222; color:#ddd; font-family:monospace; margin:16px }
img { image-rendering:pixelated; border:1px solid #555; max-width:90vw;
      cursor:crosshair; user-select:none; -webkit-user-drag:none }
input { width:60%; background:#333; color:#eee; border:1px solid #555;
        padding:4px }
button { background:#333; color:#eee; border:1px solid #555; padding:4px }
#log { white-space:pre-wrap; color:#9c9 } .err { color:#c99 }
</style></head><body>
<h3>cadrays_tpu <span id="st"></span>
    <button id="pause" onclick="pause()">pause</button>
    <select id="mode">
      <option value="orbit">orbit</option>
      <option value="fly">fly (WASDQE + drag look)</option>
      <option value="move">move object</option>
      <option value="rotate">rotate object</option>
      <option value="scale">scale object</option>
    </select>
    <span id="sel"></span></h3>
<img id="view" src="/frame.png" draggable="false"/>
<p><input id="cmd" placeholder="command (e.g. vbsdf s -kd 1 0 0)"
   onkeydown="if(event.key=='Enter')run()"/></p>
<details><summary>script editor</summary>
<p><select id="scripts" onchange="loadScript()"></select>
   <input id="sname" style="width:20%" placeholder="name.crt"/>
   <button onclick="saveScript(false)">save</button>
   <button onclick="saveScript(true)">save+run</button>
   <button onclick="delScript()">delete</button></p>
<textarea id="stext" rows="14" style="width:90vw;background:#2a2a2a;
  color:#dfd;border:1px solid #555;font-family:monospace"></textarea>
</details>
<details><summary>scene tree</summary><div id="tree"></div></details>
<details><summary>material</summary>
<p><span id="mname">(pick an object)</span>
   <select id="preset" onchange="applyPreset()">
     <option value="">preset...</option>
     <option>matte</option><option>metal</option><option>glossy</option>
     <option>glass</option><option>paint</option><option>mirror</option>
     <option>gold</option><option>copper</option><option>chrome</option>
   </select></p>
<div id="mat"></div></details>
<details><summary>transform</summary><div id="xform"></div></details>
<details><summary>render settings</summary><div id="settings"></div>
</details>
<details><summary>lights</summary>
<p><button onclick="addLight('positional')">+ positional</button>
   <button onclick="addLight('directional')">+ directional</button></p>
<div id="lights"></div></details>
<div id="log"></div>
<script>
async function refreshScripts(){
  const names = await (await fetch('/scripts')).json();
  const sel = document.getElementById('scripts');
  sel.innerHTML = '<option value="">-- scripts --</option>' +
    names.map(n => `<option>${n}</option>`).join('');
}
refreshScripts();
async function loadScript(){
  const n = document.getElementById('scripts').value;
  if (!n) return;
  document.getElementById('sname').value = n;
  document.getElementById('stext').value =
    await (await fetch('/script?name=' + encodeURIComponent(n))).text();
}
async function saveScript(run){
  const name = document.getElementById('sname').value;
  if (!name) return;
  const r = await fetch('/script', {method:'POST', body: JSON.stringify(
    {name: name, text: document.getElementById('stext').value, run: run})});
  logLine((run ? 'run ' : 'save ') + name, await r.text());
  refreshScripts();
}
async function delScript(){
  const name = document.getElementById('sname').value;
  if (!name) return;
  const r = await fetch('/script_delete', {method:'POST',
    body: JSON.stringify({name: name})});
  logLine('delete ' + name, await r.text());
  refreshScripts();
}
async function refreshTree(){
  const roots = await (await fetch('/tree')).json();
  const render = (n, depth) =>
    `<div style="margin-left:${depth * 14}px">` +
    `<span style="cursor:pointer" onclick="toggleEye('${n.name}')">` +
    `${n.visible ? '&#128065;' : '&#8212;'}</span> ` +
    `<span style="cursor:pointer" onclick="selectNode('${n.name}')">` +
    `${n.name}</span></div>` +
    n.children.map(c => render(c, depth + 1)).join('');
  document.getElementById('tree').innerHTML =
    roots.map(r => render(r, 0)).join('');
}
async function toggleEye(name){
  await fetch('/node', {method:'POST',
    body: JSON.stringify({name: name, op: 'toggle'})});
  refreshTree();
}
async function selectNode(name){
  selected = name;
  document.getElementById('sel').textContent = '[' + name + ']';
  refreshMat();
  refreshXform();
}
const XF = [['translation','T'],['rotation_deg','R&deg;'],['scale','S']];
async function refreshXform(){
  if (!selected) return;
  const t = await (await fetch('/transform?names=' +
    encodeURIComponent(selected))).json();
  let h = '';
  for (const [k, lbl] of XF){
    h += `<div>${lbl}: ` + t[k].map((x, i) =>
      `<input style="width:5em" id="x_${k}_${i}" value="${x.toFixed(4)}"/>`
    ).join('') + '</div>';
  }
  h += '<button onclick="applyXform()">apply</button>' +
       ' <button onclick="resetXform()">reset</button>';
  document.getElementById('xform').innerHTML = h;
}
async function applyXform(){
  const req = {names: [selected]};
  for (const [k] of XF){
    const v = [];
    for (let i = 0; i < 3; i++)
      v.push(parseFloat(document.getElementById(`x_${k}_${i}`).value));
    req[k] = v;
  }
  logLine('transform ' + selected,
    await (await fetch('/transform', {method:'POST',
      body: JSON.stringify(req)})).text());
  refreshXform();
}
async function resetXform(){
  await fetch('/transform', {method:'POST',
    body: JSON.stringify({names: [selected], reset: true})});
  refreshXform();
}
const MATF = [['kd',3],['ks',3],['kt',3],['kc',3],['le',3],
  ['baseRoughness',1],['coatRoughness',1],['absorpColor',3],
  ['absorpCoeff',1]];
async function refreshMat(){
  if (!selected) return;
  const m = await (await fetch('/material?name=' +
    encodeURIComponent(selected))).json();
  document.getElementById('mname').textContent =
    m.name + ' (' + m.preset + ')';
  let h = '';
  for (const [k, n] of MATF){
    const v = n === 1 ? [m[k]] : m[k];
    h += `<div>${k}: ` + v.map((x, i) =>
      `<input style="width:5em" id="m_${k}_${i}" value="${x}"/>`
    ).join('') + '</div>';
  }
  for (const fk of ['baseFresnel', 'coatFresnel']){
    h += `<div>${fk}: <select id="m_${fk}_t">` +
      ['Constant','Schlick','Conductor','Dielectric'].map(t =>
        `<option ${t === m[fk].type ? 'selected' : ''}>${t}</option>`
      ).join('') + '</select>' + m[fk].params.slice(0, 3).map((x, i) =>
      `<input style="width:5em" id="m_${fk}_${i}" value="${x}"/>`
    ).join('') + '</div>';
  }
  h += '<button onclick="applyMat()">apply</button>';
  document.getElementById('mat').innerHTML = h;
}
async function applyMat(){
  const req = {name: selected};
  for (const [k, n] of MATF){
    const v = [];
    for (let i = 0; i < n; i++)
      v.push(parseFloat(document.getElementById(`m_${k}_${i}`).value));
    req[k] = n === 1 ? v[0] : v;
  }
  for (const fk of ['baseFresnel', 'coatFresnel']){
    const t = document.getElementById(`m_${fk}_t`).value;
    const np = {Constant:1, Schlick:3, Conductor:2, Dielectric:1}[t];
    const ps = [];
    for (let i = 0; i < np; i++)
      ps.push(parseFloat(document.getElementById(`m_${fk}_${i}`).value));
    req[fk] = {type: t, params: ps};
  }
  logLine('material ' + selected,
    await (await fetch('/material', {method:'POST',
      body: JSON.stringify(req)})).text());
  refreshMat();
}
async function applyPreset(){
  const p = document.getElementById('preset').value;
  if (!p || !selected) return;
  await fetch('/material', {method:'POST',
    body: JSON.stringify({name: selected, preset: p})});
  refreshMat();
}
async function refreshSettings(){
  const st = await (await fetch('/settings')).json();
  document.getElementById('settings').innerHTML =
    `mode <select id="rs_mode">` +
    ['gi','rt','raster'].map(m =>
      `<option ${m === st.mode ? 'selected' : ''}>${m}</option>`
    ).join('') + '</select>' +
    ` depth <input id="rs_depth" style="width:3em" value="${st.ray_depth}"/>` +
    ` clamp <input id="rs_clamp" style="width:4em" value="${st.clamp}"/>` +
    ` res <input id="rs_w" style="width:4em" value="${st.width}"/>x` +
    `<input id="rs_h" style="width:4em" value="${st.height}"/>` +
    ` fov <input id="rs_fov" style="width:3em" value="${st.fovy}"/>` +
    ` <label><input type="checkbox" id="rs_two" ${st.two_sided ? 'checked' : ''}/>2-sided</label>` +
    ` <label><input type="checkbox" id="rs_issd" ${st.adaptive_debug ? 'checked' : ''}/>tiles</label>` +
    ` <label><input type="checkbox" id="rs_aa" ${st.rt_aa ? 'checked' : ''}/>AA</label>` +
    ' <button onclick="applySettings()">apply</button>';
}
async function applySettings(){
  const req = {
    mode: document.getElementById('rs_mode').value,
    ray_depth: parseInt(document.getElementById('rs_depth').value),
    clamp: parseFloat(document.getElementById('rs_clamp').value),
    width: parseInt(document.getElementById('rs_w').value),
    height: parseInt(document.getElementById('rs_h').value),
    fovy: parseFloat(document.getElementById('rs_fov').value),
    two_sided: document.getElementById('rs_two').checked,
    adaptive_debug: document.getElementById('rs_issd').checked,
    rt_aa: document.getElementById('rs_aa').checked,
  };
  logLine('settings', await (await fetch('/settings',
    {method:'POST', body: JSON.stringify(req)})).text());
  refreshSettings();
}
async function refreshLights(){
  const ls = await (await fetch('/lights')).json();
  document.getElementById('lights').innerHTML = ls.map((l, i) =>
    `<div>#${i} ${l.kind} int=${l.intensity} sm=${l.smooth}` +
    ` vec=[${l.vec.map(v => v.toFixed(2))}]` +
    ` <button onclick="lightOp(${i},'clone')">clone</button>` +
    ` <button onclick="lightOp(${i},'del')">del</button></div>`
  ).join('');
}
async function lightOp(i, op){
  await fetch('/light', {method:'POST',
    body: JSON.stringify({op: op, idx: i})});
  refreshLights();
}
async function addLight(kind){
  await fetch('/light', {method:'POST',
    body: JSON.stringify({op: 'add', kind: kind, intensity: 10})});
  refreshLights();
}
refreshTree(); refreshLights(); refreshSettings();
const img = document.getElementById('view');
let drag = null, moved = false, selected = null;
const keys = new Set();
function mode(){ return document.getElementById('mode').value; }
function imgXY(e){
  const r = img.getBoundingClientRect();
  return [ (e.clientX - r.left) * img.naturalWidth / r.width,
           (e.clientY - r.top) * img.naturalHeight / r.height ];
}
img.addEventListener('mousedown', e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 1};
  moved = false; e.preventDefault();
});
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (Math.abs(dx) + Math.abs(dy) < 2) return;
  moved = true;
  const m = mode();
  if (m === 'fly') {
    fetch('/fly', {method:'POST', body: JSON.stringify({dx: dx, dy: dy})});
  } else if (m !== 'orbit' && selected) {
    const op = m === 'move' ? 'translate' : m;
    fetch('/manip', {method:'POST', body: JSON.stringify(
      {name: selected, op: op, dx: dx, dy: dy})});
  } else {
    fetch('/orbit', {method:'POST', body: JSON.stringify(
      {op: drag.pan ? 'pan' : 'rotate', dx: dx, dy: dy})});
  }
  drag.x = e.clientX; drag.y = e.clientY;
});
window.addEventListener('mouseup', async e => {
  if (!drag) return;
  const wasDrag = moved; drag = null;
  if (wasDrag) return;
  const [x, y] = imgXY(e);
  const r = await fetch('/pick', {method:'POST',
    body: JSON.stringify({x: x, y: y, prev: selected})});
  const t = await r.text();
  logLine('pick ' + Math.round(x) + ' ' + Math.round(y), t);
  const m = t.match(/^hit (\\S+)/);
  if (m) {
    selected = m[1];
    document.getElementById('sel').textContent = '[' + selected + ']';
    const box = document.getElementById('cmd');
    box.value = 'vbsdf ' + m[1] + ' ';
    box.focus();
  } else {
    selected = null;
    document.getElementById('sel').textContent = '';
  }
});
window.addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'TEXTAREA')
    return;
  keys.add(e.key.toLowerCase());
});
window.addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
setInterval(() => {
  if (mode() !== 'fly' || keys.size === 0) return;
  fetch('/fly', {method:'POST', body: JSON.stringify(
    {keys: [...keys], dt: 0.1})});
}, 100);
img.addEventListener('wheel', e => {
  e.preventDefault();
  fetch('/orbit', {method:'POST', body: JSON.stringify(
    {op: 'zoom', dx: 0, dy: e.deltaY > 0 ? -1 : 1})});
}, {passive: false});
async function pause(){
  const r = await fetch('/pause', {method:'POST'});
  document.getElementById('pause').textContent =
      (await r.text()) === 'paused' ? 'resume' : 'pause';
}
function logLine(cmd, out){
  const log = document.getElementById('log');
  log.textContent = '> ' + cmd + '\\n' + out + '\\n' + log.textContent;
}
async function tick(){
  const s = await (await fetch('/status')).json();
  document.getElementById('st').textContent =
      ` ${s.width}x${s.height} spp=${s.spp}` + (s.paused ? ' [paused]' : '');
  img.src = '/frame.png?' + Date.now();
}
setInterval(tick, 1000);
async function run(){
  const box = document.getElementById('cmd');
  const r = await fetch('/exec', {method:'POST', body: box.value});
  logLine(box.value, await r.text());
  box.value='';
}
</script></body></html>"""


class ViewerState:
    def __init__(self, session):
        self.session = session
        self.lock = threading.Lock()
        self.png_bytes = b""
        self.spp = 0
        self.running = True
        self.paused = False


def _make_handler(state: ViewerState, console):
    import os
    import urllib.parse

    import numpy as np

    from cadrays_tpu.cli.controls import FlightControls, OrbitControls

    orbit = OrbitControls()
    flight = FlightControls(move_speed=2.0)

    def _manipulate(req):
        """Drag-manipulate a picked node: screen-space translate, view-
        axis rotate, or uniform scale about its bbox center — the
        ImGuizmo/TransformWidget contract (ImRaytraceControls.cxx:32-91,
        TransformWidget.cxx:112-246). Mutating the transform bumps the
        scene version, so accumulation restarts."""
        s = state.session
        node = s.scene.model.get(req["name"])
        if node is None:
            raise ValueError(f"no node '{req['name']}'")
        cam = s.camera
        right, up, fwd = cam.basis_np()
        dx = float(req.get("dx", 0.0))
        dy = float(req.get("dy", 0.0))
        op = req.get("op", "translate")
        if op == "translate":
            dist = float(np.linalg.norm(np.asarray(cam.at)
                                        - np.asarray(cam.eye)))
            fov = np.deg2rad(float(cam.fovy_deg))
            wpp = 2.0 * dist * np.tan(fov / 2) / max(s.height, 1)
            delta = (dx * right - dy * up) * wpp
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = delta
            node.transform = (m @ node.transform).astype(np.float32)
        else:
            # rotate/scale about the subtree bbox center
            los, his = [], []
            for n in node.traverse():
                if n.mesh is not None:
                    mm = n.mesh.transformed(n.world_transform())
                    lo, hi = mm.bounds()
                    los.append(lo)
                    his.append(hi)
            c = ((np.min(los, axis=0) + np.max(his, axis=0)) / 2
                 if los else np.zeros(3))
            t0 = np.eye(4, dtype=np.float32)
            t0[:3, 3] = -c
            t1 = np.eye(4, dtype=np.float32)
            t1[:3, 3] = c
            if op == "rotate":
                ang = dx * 0.01
                ca, sa = np.cos(ang), np.sin(ang)
                a = np.asarray(fwd, np.float64)
                x, y, z = a
                r = np.eye(4, dtype=np.float32)
                r[:3, :3] = np.array([
                    [ca + x * x * (1 - ca), x * y * (1 - ca) - z * sa,
                     x * z * (1 - ca) + y * sa],
                    [y * x * (1 - ca) + z * sa, ca + y * y * (1 - ca),
                     y * z * (1 - ca) - x * sa],
                    [z * x * (1 - ca) - y * sa, z * y * (1 - ca) + x * sa,
                     ca + z * z * (1 - ca)]], np.float32)
            elif op == "scale":
                sf = float(np.exp(-dy * 0.005))
                r = np.diag([sf, sf, sf, 1.0]).astype(np.float32)
            else:
                raise ValueError(f"unknown manip op {op!r}")
            node.transform = (t1 @ r @ t0 @ node.transform).astype(
                np.float32)
        s.scene.touch()

    # ---- numeric TRS panel (TransformWidget.cxx:112-246) ---------------
    def _decompose_trs(m):
        """4x4 -> (translation, Euler XYZ degrees, per-axis scale);
        inverse of _compose_trs. Euler convention: R = Rz @ Ry @ Rx
        (angles reported in the reference panel's XYZ slider order)."""
        t = m[:3, 3].tolist()
        sx = float(np.linalg.norm(m[:3, 0]))
        sy = float(np.linalg.norm(m[:3, 1]))
        sz = float(np.linalg.norm(m[:3, 2]))
        r = m[:3, :3] / np.asarray([max(sx, 1e-12), max(sy, 1e-12),
                                    max(sz, 1e-12)])
        ry = float(np.arcsin(np.clip(-r[2, 0], -1.0, 1.0)))
        if abs(np.cos(ry)) > 1e-6:
            rx = float(np.arctan2(r[2, 1], r[2, 2]))
            rz = float(np.arctan2(r[1, 0], r[0, 0]))
        else:  # gimbal: fold Z into X like the reference does
            rx = float(np.arctan2(-r[1, 2], r[1, 1]))
            rz = 0.0
        deg = [float(np.degrees(a)) for a in (rx, ry, rz)]
        return t, deg, [sx, sy, sz]

    def _compose_trs(t, deg, s):
        rx, ry, rz = [np.radians(a) for a in deg]

        def rot(c, sn, axis):
            m = np.eye(3)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            m[i, i] = c
            m[j, j] = c
            m[i, j] = -sn if axis != 1 else sn
            m[j, i] = sn if axis != 1 else -sn
            return m

        r = (rot(np.cos(rz), np.sin(rz), 2)
             @ rot(np.cos(ry), np.sin(ry), 1)
             @ rot(np.cos(rx), np.sin(rx), 0))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = (r * np.asarray(s)).astype(np.float32)
        m[:3, 3] = np.asarray(t, np.float32)
        return m

    def _subtree_center(nodes):
        los, his = [], []
        for node in nodes:
            for n in node.traverse():
                if n.mesh is not None:
                    mm = n.mesh.transformed(n.world_transform())
                    lo, hi = mm.bounds()
                    los.append(lo)
                    his.append(hi)
        if not los:
            return np.zeros(3, np.float32)
        return ((np.min(los, axis=0) + np.max(his, axis=0)) / 2) \
            .astype(np.float32)

    def _xform_nodes(names):
        s = state.session
        nodes = []
        for nm in names:
            node = s.scene.model.get(nm)
            if node is None:
                raise ValueError(f"no node '{nm}'")
            nodes.append(node)
        return nodes

    def _transform_json(names):
        """Single select: decomposed local TRS (absolute edit fields).
        Multi select: anchor = mean of subtree bbox centers, zero
        rotation, unit scale (delta edit fields) — TransformWidget.cxx
        semantics."""
        nodes = _xform_nodes(names)
        if len(nodes) == 1:
            t, r, sc = _decompose_trs(
                np.asarray(nodes[0].transform, np.float64))
            return {"mode": "absolute", "translation": t,
                    "rotation_deg": r, "scale": sc}
        anchor = np.mean([_subtree_center([n]) for n in nodes], axis=0)
        return {"mode": "delta", "translation": anchor.tolist(),
                "rotation_deg": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0]}

    def _transform_edit(req):
        nodes = _xform_nodes(req["names"])
        s = state.session
        if req.get("reset"):
            for n in nodes:
                n.transform = np.eye(4, dtype=np.float32)
            s.scene.touch()
            return
        t = [float(x) for x in req.get("translation", (0, 0, 0))]
        r = [float(x) for x in req.get("rotation_deg", (0, 0, 0))]
        sc = [float(x) for x in req.get("scale", (1, 1, 1))]
        if len(nodes) == 1:
            nodes[0].transform = _compose_trs(t, r, sc)
        else:
            # delta about the common anchor: translation field holds the
            # new anchor position; rotation/scale apply relative
            anchor = np.mean([_subtree_center([n]) for n in nodes],
                             axis=0)
            delta = _compose_trs([0, 0, 0], r, sc)
            t0 = np.eye(4, dtype=np.float32)
            t0[:3, 3] = -anchor
            t1 = np.eye(4, dtype=np.float32)
            t1[:3, 3] = anchor + (np.asarray(t, np.float32) - anchor)
            m = t1 @ delta @ t0  # WORLD-space edit about the anchor
            for n in nodes:
                # conjugate into the node's parent frame: world' = m @
                # world and world = parent_world @ local, so local' =
                # inv(pw) @ m @ pw @ local (a raw m @ local would rotate
                # about a parent-transformed pivot for nested nodes)
                pw = (n.parent.world_transform()
                      if n.parent is not None else np.eye(4))
                pw = np.asarray(pw, np.float64)
                n.transform = (np.linalg.inv(pw) @ m.astype(np.float64)
                               @ pw @ np.asarray(n.transform, np.float64)
                               ).astype(np.float32)
        s.scene.touch()

    def _tree_json(node):
        """Scene-tree panel data (DataModelWidget.cxx:246-312): nested
        name/visible/leaf records for both roots."""
        return {
            "name": node.name,
            "visible": bool(node.visible),
            "leaf": node.is_leaf,
            "children": [_tree_json(c) for c in node.children],
        }

    def _mat_json(node):
        """Material panel read-back incl. the preset classification from
        nonzero lobes (MaterialEditor.cxx:350-370)."""
        m = node.material
        a = lambda x: [round(float(v), 6)
                       for v in np.asarray(x).reshape(-1)]
        kd, ks, kt, kc = a(m.kd), a(m.ks), a(m.kt), a(m.kc)
        nz = lambda v: max(v) > 0.0
        if nz(kc):
            kind = "paint"
        elif nz(kt):
            kind = "glass"
        elif nz(kd) and nz(ks):
            kind = "glossy"
        elif nz(ks):
            kind = "metal"
        elif nz(kd):
            kind = "matte"
        else:
            kind = "custom"
        fre = lambda t, p: {"type": ["Constant", "Schlick", "Conductor",
                                     "Dielectric"][int(np.asarray(t)[0])],
                            "params": a(p)}
        return {
            "name": node.name, "preset": kind,
            "kd": kd, "ks": ks, "kt": kt, "kc": kc, "le": a(m.le),
            "baseRoughness": a(m.base_rough)[0],
            "coatRoughness": a(m.coat_rough)[0],
            "absorpColor": a(m.absorp_color),
            "absorpCoeff": a(m.absorp_coeff)[0],
            "baseFresnel": fre(m.base_ftype, m.base_fparams),
            "coatFresnel": fre(m.coat_ftype, m.coat_fparams),
        }

    _BSDF_FLAGS = {  # JSON key -> (vbsdf flag, arity)
        "kd": ("-Kd", 3), "ks": ("-Ks", 3), "kt": ("-Kt", 3),
        "kc": ("-Kc", 3), "le": ("-Le", 3),
        "baseRoughness": ("-baseRoughness", 1),
        "coatRoughness": ("-coatRoughness", 1),
        "absorpColor": ("-absorpColor", 3),
        "absorpCoeff": ("-absorpCoeff", 1),
    }

    def _material_edit(req):
        """Panel edit -> vbsdf/vsetmaterial command line, executed via
        the console so validation, energy normalization
        (MaterialEditor.cxx:311-329) and the restart fingerprint all
        apply exactly as for typed commands."""
        name = req["name"]
        if req.get("preset"):
            return console.exec(f"vsetmaterial {name} {req['preset']}")
        parts = [f"vbsdf {name}"]
        for key, (flag, arity) in _BSDF_FLAGS.items():
            if key in req:
                v = req[key]
                vals = [v] if arity == 1 else list(v)
                parts.append(flag + " " + " ".join(f"{float(x):g}"
                                                   for x in vals))
        for key, flag in (("baseFresnel", "-baseFresnel"),
                          ("coatFresnel", "-coatFresnel")):
            if key in req:
                f = req[key]
                parts.append(f"{flag} {f['type']} " + " ".join(
                    f"{float(x):g}" for x in f["params"]))
        if req.get("normalize"):
            parts.append("-n")
        return console.exec(" ".join(parts))

    def _lights_json():
        sc = state.session.scene
        out = []
        for lt in sc.lights:
            out.append({
                "kind": ("directional" if int(np.asarray(lt.kind)[0]) == 0
                         else "positional"),
                "color": [round(float(v), 6)
                          for v in np.asarray(lt.color).reshape(-1)],
                "intensity": float(np.asarray(lt.intensity)[0]),
                "vec": [round(float(v), 6)
                        for v in np.asarray(lt.vec).reshape(-1)],
                "smooth": float(np.asarray(lt.smooth)[0]),
                "headlight": bool(float(np.asarray(lt.headlight)[0])),
            })
        return out

    def _light_edit(req):
        """Light panel ops over the vlight command surface
        (LightSourcesEditor.cxx:47-87, 211-310)."""
        op = req.get("op")
        if op == "add":
            kind = req.get("kind", "positional")
            vec = req.get("vec", [0.5, 0.5, 1.0])
            cmd = (f"vlight add {kind} "
                   f"{'dir' if kind.startswith('dir') else 'pos'} "
                   + " ".join(f"{float(v):g}" for v in vec)
                   + f" int {float(req.get('intensity', 1.0)):g}"
                   + f" sm {float(req.get('smooth', 0.0)):g}")
            return console.exec(cmd)
        if op == "del":
            return console.exec(f"vlight del {int(req['idx'])}")
        if op == "clone":
            src = _lights_json()[int(req["idx"])]
            return _light_edit({"op": "add", **src})
        if op == "change":
            idx = int(req["idx"])
            parts = [f"vlight change {idx}"]
            if "vec" in req:
                kind = _lights_json()[idx]["kind"]
                key = "dir" if kind == "directional" else "pos"
                parts.append(key + " " + " ".join(
                    f"{float(v):g}" for v in req["vec"]))
            if "color" in req:
                parts.append("color " + " ".join(
                    f"{float(v):g}" for v in req["color"]))
            if "intensity" in req:
                parts.append(f"int {float(req['intensity']):g}")
            if "smooth" in req:
                parts.append(f"sm {float(req['smooth']):g}")
            return console.exec(" ".join(parts))
        raise ValueError(f"unknown light op {op!r}")

    def script_dir():
        d = os.path.join(state.session.cwd or ".", "scripts")
        os.makedirs(d, exist_ok=True)
        return d

    def script_path(name):
        # keep names inside the script dir (no path traversal)
        base = os.path.basename(name)
        if not base or os.path.splitext(base)[1] not in (".crt", ".tcl"):
            raise ValueError(f"script name must end in .crt/.tcl: {name!r}")
        return os.path.join(script_dir(), base)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                with state.lock:
                    body = state.png_bytes
                self._send(200, "image/png", body or b"")
            elif self.path.startswith("/status"):
                s = state.session
                body = json.dumps({
                    "spp": state.spp, "width": s.width, "height": s.height,
                    "mode": s.params.mode, "paused": state.paused,
                }).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/tree"):
                s = state.session
                with state.lock:
                    body = json.dumps([
                        _tree_json(s.scene.model.shapes_root),
                        _tree_json(s.scene.model.meshes_root),
                    ]).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/material?"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                # lock: POST handlers + render loop mutate these
                # structures; an unlocked read can tear mid-edit
                with state.lock:
                    node = state.session.scene.model.get(q["name"][0])
                    body = None if node is None \
                        else json.dumps(_mat_json(node)).encode()
                if body is None:
                    self._send(404, "text/plain", b"no such node")
                else:
                    self._send(200, "application/json", body)
            elif self.path.startswith("/transform?"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                names = q["names"][0].split(",")
                try:
                    with state.lock:
                        body = json.dumps(_transform_json(names)).encode()
                    self._send(200, "application/json", body)
                except ValueError as e:
                    self._send(404, "text/plain", str(e).encode())
            elif self.path.startswith("/lights"):
                with state.lock:
                    body = json.dumps(_lights_json()).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/settings"):
                s = state.session
                with state.lock:
                    p = s.params
                    body = json.dumps({
                        "width": s.width, "height": s.height,
                        "mode": p.mode, "ray_depth": p.ray_depth,
                        "clamp": float(np.asarray(p.radiance_clamp)),
                        "two_sided": bool(p.two_sided),
                        "coherent": bool(p.coherent),
                        "adaptive": bool(p.adaptive),
                        "adaptive_debug": bool(p.adaptive_debug),
                        "persistent": bool(p.persistent),
                        "rt_aa": bool(p.rt_aa),
                        "fovy": float(s.camera.fovy_deg),
                    }).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/scripts"):
                names = sorted(f for f in os.listdir(script_dir())
                               if f.endswith((".crt", ".tcl")))
                self._send(200, "application/json",
                           json.dumps(names).encode())
            elif self.path.startswith("/script?"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                try:
                    with open(script_path(q["name"][0])) as f:
                        self._send(200, "text/plain", f.read().encode())
                except Exception as e:
                    self._send(404, "text/plain", f"[error] {e}".encode())
            else:
                self._send(200, "text/html", _PAGE.encode())

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n).decode()

        def do_POST(self):
            s = state.session
            if self.path.startswith("/exec"):
                cmd = self._body()
                try:
                    with state.lock:
                        out = console.exec(cmd)
                    self._send(200, "text/plain", (out or "ok").encode())
                except Exception as e:
                    self._send(200, "text/plain",
                               f"[error] {e}".encode())
            elif self.path.startswith("/orbit"):
                # camera edit -> fingerprint change -> accumulation
                # restart in the render loop (AppViewer.cxx:979-984)
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        cam = s.camera
                        if req["op"] == "rotate":
                            cam = orbit.rotate(cam, req["dx"], req["dy"])
                        elif req["op"] == "pan":
                            cam = orbit.pan(cam, req["dx"], req["dy"],
                                            s.height)
                        elif req["op"] == "zoom":
                            cam = orbit.zoom(cam, req["dy"])
                        s.camera = cam
                    self._send(200, "text/plain", b"ok")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/manip"):
                # drag-gizmo: translate/rotate/scale the picked node
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        _manipulate(req)
                    self._send(200, "text/plain", b"ok")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/fly"):
                # WASD flight + mouse look (FlightControls.cxx:223-263)
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        cam = s.camera
                        if req.get("dx") or req.get("dy"):
                            cam = flight.look(cam, req.get("dx", 0.0),
                                              req.get("dy", 0.0))
                        keys = set(req.get("keys", []))
                        dt = float(req.get("dt", 1 / 30))
                        fwd = (("w" in keys) - ("s" in keys))
                        strafe = (("d" in keys) - ("a" in keys))
                        lift = (("e" in keys) - ("q" in keys))
                        if fwd or strafe or lift:
                            cam = flight.move(cam, fwd, strafe, lift, dt)
                        s.camera = cam
                        s.scene.camera = cam
                    self._send(200, "text/plain", b"ok")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/pick"):
                # Selection promotion (AppViewer.cxx:283-460): a click
                # selects the TOPMOST ancestor group of the picked leaf;
                # clicking again while that group is selected drills one
                # level down toward the leaf (common-ancestor logic).
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        out = console.exec(
                            f"vpick {float(req['x'])} {float(req['y'])}")
                    if out.startswith("hit "):
                        leaf = out.split()[1]
                        prev = req.get("prev")
                        chain = []
                        node = s.scene.model.get(leaf)
                        while node is not None and node.parent is not None \
                                and node.parent.parent is not None:
                            chain.append(node.name)
                            node = node.parent
                        if node is not None and node.parent is not None:
                            chain.append(node.name)
                        # chain = [leaf ... topmost]; pick the next level
                        # below the currently selected ancestor, else top
                        sel = chain[-1] if chain else leaf
                        if prev in chain:
                            i = chain.index(prev)
                            if i > 0:
                                sel = chain[i - 1]
                        out = out.replace(f"hit {leaf}",
                                          f"hit {sel}", 1) \
                            + f" leaf={leaf}"
                    self._send(200, "text/plain", out.encode())
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/node"):
                # per-node eye toggle (DataModelWidget.cxx:246-264)
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        node = s.scene.model.get(req["name"])
                        if node is None:
                            raise ValueError(f"no node '{req['name']}'")
                        op = req.get("op", "toggle")
                        if op == "show" or (op == "toggle"
                                            and not node.visible):
                            node.show()
                        else:
                            node.hide()
                        s.scene.touch()
                    self._send(200, "text/plain", b"ok")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/transform"):
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        _transform_edit(req)
                    self._send(200, "text/plain", b"ok")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/material"):
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        out = _material_edit(req)
                    self._send(200, "text/plain", (out or "ok").encode())
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/light"):
                try:
                    req = json.loads(self._body())
                    with state.lock:
                        out = _light_edit(req)
                    self._send(200, "text/plain", (out or "ok").encode())
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/settings"):
                # render-settings panel -> vrenderparams/vrtsize/vcamera
                # command lines (SettingsWidget.cxx parity via the same
                # validated path as typed commands)
                try:
                    req = json.loads(self._body())
                    cmds = []
                    if "width" in req or "height" in req:
                        w = int(req.get("width", s.width))
                        h = int(req.get("height", s.height))
                        cmds.append(f"vrtsize {w} {h}")
                    if "mode" in req:
                        flag = {"gi": "-gi", "rt": "-ray",
                                "raster": "-rast"}[req["mode"]]
                        cmds.append(f"vrenderparams {flag}")
                    if "ray_depth" in req:
                        cmds.append(
                            f"vrenderparams -rayDepth {int(req['ray_depth'])}")
                    if "clamp" in req:
                        cmds.append(
                            f"vrenderparams -clamping {float(req['clamp']):g}")
                    for key, flag in (("two_sided", "-twoside"),
                                      ("coherent", "-coherent"),
                                      ("adaptive_debug", "-issd"),
                                      ("persistent", "-persistent"),
                                      ("rt_aa", "-aa")):
                        if key in req:
                            cmds.append(f"vrenderparams {flag} "
                                        f"{1 if req[key] else 0}")
                    if req.get("adaptive"):
                        cmds.append("vrenderparams -iss")
                    if "fovy" in req:
                        cmds.append(f"vcamera -fovy {float(req['fovy']):g}")
                    with state.lock:
                        for c in cmds:
                            console.exec(c)
                    self._send(200, "text/plain", b"ok")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/pause"):
                state.paused = not state.paused
                self._send(200, "text/plain",
                           b"paused" if state.paused else b"running")
            elif self.path.startswith("/script_delete"):
                try:
                    req = json.loads(self._body())
                    os.remove(script_path(req["name"]))
                    self._send(200, "text/plain", b"deleted")
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            elif self.path.startswith("/script"):
                # save (+ optionally run) — ScriptEditor.cxx:134-263
                try:
                    req = json.loads(self._body())
                    path = script_path(req["name"])
                    with open(path, "w") as f:
                        f.write(req.get("text", ""))
                    out = "saved"
                    if req.get("run"):
                        with state.lock:
                            res = console.source(path)
                        out = f"saved + run\n{res or ''}".rstrip()
                    self._send(200, "text/plain", out.encode())
                except Exception as e:
                    self._send(200, "text/plain", f"[error] {e}".encode())
            else:
                self._send(404, "text/plain", b"")

    return Handler


def _encode_png(session) -> bytes:
    import numpy as np

    from cadrays_tpu.core.tonemap import apply_tonemap, linear_to_srgb
    from cadrays_tpu.utils.image import write_png

    if session.params.adaptive_debug and session.params.adaptive:
        from cadrays_tpu.integrator.adaptive import debug_tile_overlay
        ldr = np.asarray(debug_tile_overlay(
            session.progressive.weight, session.width, session.height))
    else:
        hdr = np.asarray(session.progressive.image)
        ldr = np.asarray(linear_to_srgb(apply_tonemap(
            hdr, session.params.tonemap)))
    buf = io.BytesIO()
    write_png(buf, ldr)
    return buf.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("script", nargs="?", default=None)
    ap.add_argument("--port", type=int, default=8790)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp-per-pass", type=int, default=1)
    args = ap.parse_args(argv)
    from cadrays_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from cadrays_tpu.cli.commands import Session, make_console
    from cadrays_tpu.integrator.progressive import progressive_step

    session = Session()
    console = make_console(session)
    if args.script:
        import os

        session.cwd = os.path.dirname(os.path.abspath(args.script)) or "."
        console.source(args.script)
    session.width = session.height = args.res

    state = ViewerState(session)
    server = ThreadingHTTPServer(("127.0.0.1", args.port),
                                 _make_handler(state, console))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer at http://127.0.0.1:{args.port}  (ctrl-C stops)")

    try:
        while True:
            if state.paused:
                time.sleep(0.1)
                continue
            with state.lock:
                data = session.scene.flatten(session.camera)
                cam, params = session.camera, session.params
                w, h, prog = session.width, session.height, session.progressive
            st = progressive_step(data, cam, params, w, h, prog,
                                  samples_per_step=args.spp_per_pass)
            with state.lock:
                session.progressive = st
                state.spp = int(st.spp)
                state.png_bytes = _encode_png(session)
    except KeyboardInterrupt:
        print("bye")
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
