"""Interactive mask-editor UI, the manual editor's front end (counterpart
of regen3d_tpu/pipeline/editor_ui.py): a dependency-free single-page app
served by the stdlib ``ThreadingHTTPServer``, which phase 1 launches under
``interactive_edit``:

  GET  /            the editor page (canvas overlay)
  GET  /image.png   the session image
  GET  /state       JSON: the masks as base64 PNG overlays, labels, scores
  POST /op          JSON verbs: add_point, new_from_box, delete, merge,
                    resolve_overlaps, relabel, finish

Every verb maps onto :class:`~regen3d_tpu_torch.pipeline.interactive.
EditSession`, so the page and programmatic clients share one engine (one
SAM encode per session). A verb that fails answers 500 with the error's
text, an unknown one 400. ``launch_editor`` blocks until Finish and returns
the edited ``DetectionResult`` list. PNGs go through the port's own
encoder (``utils/image.encode_png``): the bytes differ from Pillow's, the
decoded pixels do not.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from regen3d_tpu_torch.pipeline.detection import DetectionResult
from regen3d_tpu_torch.pipeline.interactive import EditSession
from regen3d_tpu_torch.utils.image import encode_png

log = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>regen3d mask editor</title>
<style>
 body{font-family:system-ui,sans-serif;margin:16px;background:#181a1f;color:#e8e8e8}
 #wrap{display:flex;gap:16px}
 canvas{border:1px solid #444;cursor:crosshair;max-width:70vw}
 button{margin:2px;padding:6px 10px;background:#2d3039;color:#e8e8e8;
        border:1px solid #555;border-radius:4px;cursor:pointer}
 button.active{background:#3b82f6}
 .mask-row{padding:4px;border-bottom:1px solid #333;cursor:pointer}
 .mask-row.sel{background:#26436e}
 #side{min-width:260px}
</style></head><body>
<h3>Mask editor</h3>
<div id="wrap">
 <canvas id="cv"></canvas>
 <div id="side">
  <div>
   <button id="mode-pos" class="active">+ point</button>
   <button id="mode-neg">− point</button>
   <button id="mode-box">box→new</button>
  </div>
  <div>
   <button id="btn-delete">delete</button>
   <button id="btn-merge">merge into…</button>
   <button id="btn-resolve">resolve overlaps</button>
  </div>
  <div><input id="label" placeholder="label for new masks" value="object">
   <button id="btn-finish" style="background:#16a34a">Finish</button></div>
  <div id="masks"></div>
 </div>
</div>
<script>
let st=null, sel=0, mode="pos", mergeFrom=null, boxStart=null;
const cv=document.getElementById("cv"), ctx=cv.getContext("2d");
const img=new Image(); img.src="/image.png";
img.onload=()=>{cv.width=img.width;cv.height=img.height;refresh();};
async function refresh(){
 st=await (await fetch("/state")).json();
 if(sel>=st.masks.length)sel=Math.max(st.masks.length-1,0);
 draw(); list();}
function draw(){
 ctx.drawImage(img,0,0);
 st.masks.forEach((m,i)=>{
  const o=new Image();
  o.onload=()=>{ctx.globalAlpha=i===sel?0.55:0.3;ctx.drawImage(o,0,0);
               ctx.globalAlpha=1;};
  o.src="data:image/png;base64,"+m.overlay;});}
function list(){
 const el=document.getElementById("masks"); el.innerHTML="";
 st.masks.forEach((m,i)=>{
  const d=document.createElement("div");
  d.className="mask-row"+(i===sel?" sel":"");
  d.textContent=`#${i} ${m.label} (${m.area}px)`;
  d.onclick=()=>{if(mergeFrom!==null){op({op:"merge",i:mergeFrom,j:i});
                 mergeFrom=null;}else{sel=i;draw();list();}};
  el.appendChild(d);});}
async function op(body){
 const r=await (await fetch("/op",{method:"POST",
   headers:{"Content-Type":"application/json"},
   body:JSON.stringify(body)})).json();
 if(r.done){document.body.innerHTML="<h3>Session finished — return to the pipeline.</h3>";return;}
 refresh();}
for(const m of["pos","neg","box"]){
 document.getElementById("mode-"+m).onclick=e=>{mode=m;
  document.querySelectorAll("[id^=mode-]").forEach(b=>b.classList.remove("active"));
  e.target.classList.add("active");};}
cv.onmousedown=e=>{
 const r=cv.getBoundingClientRect();
 const x=(e.clientX-r.left)*cv.width/r.width,
       y=(e.clientY-r.top)*cv.height/r.height;
 if(mode==="box"){boxStart=[x,y];return;}
 op({op:"add_point",idx:sel,x:x,y:y,positive:mode==="pos"});};
cv.onmouseup=e=>{
 if(mode!=="box"||!boxStart)return;
 const r=cv.getBoundingClientRect();
 const x=(e.clientX-r.left)*cv.width/r.width,
       y=(e.clientY-r.top)*cv.height/r.height;
 op({op:"new_from_box",label:document.getElementById("label").value,
     x0:Math.min(boxStart[0],x),y0:Math.min(boxStart[1],y),
     x1:Math.max(boxStart[0],x),y1:Math.max(boxStart[1],y)});
 boxStart=null;};
document.getElementById("btn-delete").onclick=()=>op({op:"delete",idx:sel});
document.getElementById("btn-merge").onclick=()=>{mergeFrom=sel;};
document.getElementById("btn-resolve").onclick=()=>op({op:"resolve_overlaps"});
document.getElementById("btn-finish").onclick=()=>op({op:"finish"});
</script></body></html>"""

_COLORS = np.asarray(
    [[255, 80, 80], [80, 160, 255], [90, 220, 120], [250, 200, 70],
     [200, 100, 250], [90, 220, 220], [250, 140, 60], [160, 160, 160]],
    np.uint8)


class _EditorState:
    def __init__(self, session: EditSession):
        self.session = session
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.result: Optional[List[DetectionResult]] = None


def _make_handler(state: _EditorState):
    session = state.session

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # route to logging, not stderr
            log.debug("editor: " + fmt, *args)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/image.png":
                self._send(200, encode_png(session.image), "image/png")
            elif self.path == "/state":
                with state.lock:
                    masks = []
                    for i, m in enumerate(session.masks):
                        col = _COLORS[i % len(_COLORS)]
                        rgba = np.zeros((session.h, session.w, 4), np.uint8)
                        rgba[m.mask, :3] = col
                        rgba[m.mask, 3] = 255
                        masks.append({
                            "label": m.label,
                            "score": float(m.score),
                            "area": int(m.mask.sum()),
                            "overlay": base64.b64encode(
                                encode_png(rgba)).decode(),
                        })
                self._send(200, json.dumps(
                    {"width": session.w, "height": session.h,
                     "masks": masks}).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            if self.path != "/op":
                self._send(404, b"{}")
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            op = req.get("op")
            try:
                with state.lock:
                    if op == "add_point":
                        session.add_point(int(req["idx"]), float(req["x"]),
                                          float(req["y"]),
                                          bool(req.get("positive", True)))
                    elif op == "new_from_box":
                        session.new_from_box(str(req.get("label", "object")),
                                             float(req["x0"]),
                                             float(req["y0"]),
                                             float(req["x1"]),
                                             float(req["y1"]))
                    elif op == "delete":
                        session.delete(int(req["idx"]))
                    elif op == "merge":
                        session.merge(int(req["i"]), int(req["j"]))
                    elif op == "resolve_overlaps":
                        session.resolve_overlaps()
                    elif op == "relabel":
                        session.masks[int(req["idx"])].label = \
                            str(req["label"])
                    elif op == "finish":
                        state.result = session.finish()
                        state.done.set()
                        self._send(200, b'{"done": true}')
                        return
                    else:
                        self._send(400, json.dumps(
                            {"error": f"unknown op {op}"}).encode())
                        return
                self._send(200, b'{"ok": true}')
            except Exception as e:               # surface errors to the UI
                self._send(500, json.dumps({"error": str(e)}).encode())

    return Handler


def launch_editor(session: EditSession, host: str = "127.0.0.1",
                  port: int = 7860, open_browser: bool = False,
                  _started: Optional[threading.Event] = None
                  ) -> List[DetectionResult]:
    """Serve the editor, block until Finish, return edited detections."""
    state = _EditorState(session)
    server = ThreadingHTTPServer((host, port), _make_handler(state))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    log.info("mask editor at http://%s:%d/ — finish in the browser to "
             "continue", host, server.server_address[1])
    if _started is not None:
        _started.set()
    if open_browser:                              # pragma: no cover
        import webbrowser
        webbrowser.open(f"http://{host}:{server.server_address[1]}/")
    try:
        state.done.wait()
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=5)
    return state.result or []


def edit_segmentations_interactive(
    image: np.ndarray,
    initial_detections: List[DetectionResult],
    cfg=None,
    sam=None,
) -> List[DetectionResult]:
    """The reference's entry point: a session over ``image`` seeded with
    ``initial_detections`` (editing through ``sam`` where given), served
    on the config's ``editor_port`` (a browser opened under
    ``editor_open_browser``); blocks until Finish and returns the edited
    detections."""
    session = EditSession(image, sam=sam, initial=initial_detections)
    port = int(cfg.get("editor_port", 7860)) if cfg else 7860
    return launch_editor(session, port=port,
                         open_browser=bool(cfg.get("editor_open_browser",
                                                   False)) if cfg else False)
