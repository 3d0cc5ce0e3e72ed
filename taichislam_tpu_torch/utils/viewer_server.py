"""Interactive 3D viewer: browser front-end over the staging API.

Counterpart of the JAX package's ``utils/viewer_server.py``; the page and the
scene wire are the same bytes. TaichiSLAM's operator tool is a Taichi-GGUI
window (``taichi_slam/utils/visualization.py:124-242``): live particle
clouds / meshes / skeleton lines, per-drone pose triads and trajectories,
mouse orbit-pan-zoom (:195-215) and an options panel (particle radius,
slice-z, mesher/particle/mesh toggles, :124-141). Compute hosts often have
no display stack, so the rebuild serves the same scene to a browser:

- ``ViewerServer``: a dependency-free stdlib HTTP server (runs in a daemon
  thread) exposing
    GET  /           self-contained WebGL viewer page (orbit controls, UI)
    GET  /version    current scene version (client polls cheaply)
    GET  /scene.bin  packed little-endian binary scene snapshot
    GET  /options    viewer options as JSON
    POST /options    update options from the browser panel
- ``InteractiveRender``: drop-in ``TaichiSLAMRender`` subclass whose
  ``rendering()`` publishes the staged scene to the server and pulls the
  panel options back into the same attributes node code already reads
  (``particle_radius``, ``slice_z``, ``enable_mesher``, ``disp_particles``,
  ``disp_mesh``, ``lock_pos_drone`` — matching the reference's options()).

The binary scene format is sectioned: ``u32 magic, u32 version, then
sections [u32 tag, u32 byte_len, payload]``; all floats f32. Tags:
1 particles-xyz, 2 particle-colors, 3 mesh-vertices, 4 mesh-colors,
5 lines, 6 skeleton-edges, 7 drone-poses (id,R,T packed 13 f32),
8 trajectories (id + count + xyz...), 9 particle radius scalar.

The page is fully self-contained raw WebGL1 (no CDN, no three.js): both the
host and the browser work with zero network beyond the localhost socket.
CI asserts on the HTTP endpoints; the GL path is exercised manually.
"""

from __future__ import annotations

import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from taichislam_tpu_torch.utils.visualization import TaichiSLAMRender

_MAGIC = 0x54534C56  # "TSLV"


def _pack_section(tag: int, payload: bytes) -> bytes:
    return struct.pack("<II", tag, len(payload)) + payload


def _f32(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


class _SceneStore:
    """Latest scene + options, shared between render thread and HTTP."""

    def __init__(self):
        self.lock = threading.Lock()
        self.version = 0
        self.blob = struct.pack("<II", _MAGIC, 0)
        self.options = {
            "particle_radius": 0.025,
            "enable_slice_z": False,
            "slice_z": 0.0,
            "enable_mesher": True,
            "disp_particles": True,
            "disp_mesh": True,
            "lock_pos_drone": False,
        }

    def publish(self, blob_body: bytes):
        with self.lock:
            self.version += 1
            self.blob = struct.pack("<II", _MAGIC, self.version) + blob_body

    def snapshot(self):
        with self.lock:
            return self.version, self.blob

    def get_options(self):
        with self.lock:
            return dict(self.options)

    def set_options(self, updates: dict):
        with self.lock:
            for k, v in updates.items():
                if k in self.options:
                    self.options[k] = type(self.options[k])(v)


class ViewerServer:
    def __init__(self, port: int = 8765, host: str = "127.0.0.1"):
        self.store = _SceneStore()
        store = self.store

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # no CORS header: the page is served same-origin; a
                # wildcard would let any web page in the operator's
                # browser read live map geometry from localhost
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html; charset=utf-8",
                               _PAGE.encode())
                elif self.path.startswith("/version"):
                    v, _ = store.snapshot()
                    self._send(200, "application/json",
                               json.dumps({"version": v}).encode())
                elif self.path.startswith("/scene.bin"):
                    _, blob = store.snapshot()
                    self._send(200, "application/octet-stream", blob)
                elif self.path.startswith("/options"):
                    self._send(200, "application/json",
                               json.dumps(store.get_options()).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.startswith("/options"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        store.set_options(json.loads(self.rfile.read(n)))
                        self._send(200, "application/json", b"{}")
                    except (ValueError, TypeError) as e:
                        self._send(400, "text/plain", str(e).encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://{self.httpd.server_address[0]}:{self.port}/"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class InteractiveRender(TaichiSLAMRender):
    """TaichiSLAMRender whose rendering() publishes to a ViewerServer."""

    def __init__(self, port: int = 8765, host: str = "127.0.0.1",
                 max_particles_draw=1000000, announce=True, **kw):
        # WebGL point sprites handle max_disp_particles-scale clouds
        # directly (unlike the matplotlib fallback renderer, which keeps
        # its 200k draw cap) — default to the reference's 1M budget so the
        # interactive operator view does not silently subsample
        super().__init__(show=False, save_path=None,
                         max_particles_draw=max_particles_draw, **kw)
        self.server = ViewerServer(port=port, host=host)
        if announce:
            print(f"[Viewer] interactive viewer at {self.server.url}")

    def rendering(self):
        out = io.BytesIO()
        if self.par is not None and len(self.par):
            p = self.par
            c = self.par_color
            if len(p) > self.max_particles_draw:
                sel = np.random.default_rng(0).choice(
                    len(p), self.max_particles_draw, replace=False)
                p = p[sel]
                c = c[sel] if c is not None else None
            out.write(_pack_section(1, _f32(p[:, :3])))
            if c is not None:
                out.write(_pack_section(2, _f32(np.clip(c[:, :3], 0, 1))))
        if self.mesh_vertices is not None and len(self.mesh_vertices):
            out.write(_pack_section(3, _f32(self.mesh_vertices[:, :3])))
            if self.mesh_colors is not None and len(self.mesh_colors):
                out.write(_pack_section(
                    4, _f32(np.clip(self.mesh_colors[:, :3], 0, 1))))
        if self.lines is not None and len(self.lines):
            out.write(_pack_section(5, _f32(self.lines[:, :3])))
        for _, edges in self.skeleton_edges.items():
            e = np.asarray(edges, np.float32).reshape(-1, 3)
            if len(e):
                out.write(_pack_section(6, _f32(e)))
        for drone_id, (R, T) in self.drone_poses.items():
            buf = np.concatenate([[float(drone_id)],
                                  np.asarray(R, np.float32).reshape(9),
                                  np.asarray(T, np.float32).reshape(3)])
            out.write(_pack_section(7, _f32(buf)))
        for drone_id, traj in self.drone_trajs.items():
            t = np.asarray(traj, np.float32).reshape(-1, 3)
            buf = np.concatenate([[float(drone_id), float(len(t))],
                                  t.reshape(-1)])
            out.write(_pack_section(8, _f32(buf)))
        out.write(_pack_section(9, _f32([self.particle_radius])))
        self.server.store.publish(out.getvalue())

        # pull panel options back (reference options(), visualization.py:124)
        o = self.server.store.get_options()
        self.particle_radius = o["particle_radius"]
        self.enable_slice_z = o["enable_slice_z"]
        self.slice_z = o["slice_z"]
        self.enable_mesher = o["enable_mesher"]
        self.disp_particles = o["disp_particles"]
        self.disp_mesh = o["disp_mesh"]
        self.lock_pos_drone = o["lock_pos_drone"]
        self.frame_count += 1

    def options(self):
        pass  # the panel lives in the browser; rendering() syncs it

    def close(self):
        self.server.close()


_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>TaichiSLAM-TPU viewer</title>
<style>
 body{margin:0;background:#10131a;color:#cfd6e4;font:13px system-ui}
 #panel{position:fixed;top:10px;left:10px;background:#1b2030cc;padding:10px
        14px;border-radius:8px;min-width:220px;z-index:10}
 #gl{position:fixed;inset:0;width:100%;height:100%;z-index:0}
 #msg{z-index:10}
 #panel label{display:block;margin:6px 0}
 #msg{position:fixed;bottom:10px;left:10px;color:#8aa}
 input[type=range]{width:120px;vertical-align:middle}
</style></head><body>
<div id="panel">
 <b>TaichiSLAM-TPU</b>
 <label><input type="checkbox" id="disp_particles" checked> particles</label>
 <label><input type="checkbox" id="disp_mesh" checked> mesh</label>
 <label><input type="checkbox" id="enable_mesher" checked> mesher</label>
 <label><input type="checkbox" id="lock_pos_drone"> follow drone</label>
 <label><input type="checkbox" id="enable_slice_z"> slice view</label>
 <label>radius <input type="range" id="particle_radius" min="0.005"
   max="0.1" step="0.005" value="0.025"><span id="rv">0.025</span></label>
 <label>slice z <input type="range" id="slice_z" min="-2" max="2"
   step="0.1" value="0"><span id="sv">0.0</span></label>
 <div id="stats"></div>
</div>
<div id="msg">connecting…</div>
<canvas id="gl"></canvas>
<script>
'use strict';
// Self-contained WebGL1 viewer: no external scripts, works fully offline.
const msg=document.getElementById('msg');
const canvas=document.getElementById('gl');
const gl=canvas.getContext('webgl',{antialias:true});
if(!gl) msg.textContent='WebGL unavailable in this browser';

// ---- tiny mat4 (column-major, like GL) ----
function mIdent(){const m=new Float32Array(16);m[0]=m[5]=m[10]=m[15]=1;
 return m;}
function mMul(a,b){const o=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k]; o[c*4+r]=s;} return o;}
function mPersp(fovy,aspect,near,far){const f=1/Math.tan(fovy/2);
 const m=new Float32Array(16);m[0]=f/aspect;m[5]=f;
 m[10]=(far+near)/(near-far);m[11]=-1;m[14]=2*far*near/(near-far);return m;}
function vSub(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function vCross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function vNorm(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return [a[0]/l,a[1]/l,a[2]/l];}
function mLookAt(eye,tgt,up){const z=vNorm(vSub(eye,tgt));
 const x=vNorm(vCross(up,z)); const y=vCross(z,x);
 const m=mIdent();
 m[0]=x[0];m[4]=x[1];m[8]=x[2];
 m[1]=y[0];m[5]=y[1];m[9]=y[2];
 m[2]=z[0];m[6]=z[1];m[10]=z[2];
 m[12]=-(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]);
 m[13]=-(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]);
 m[14]=-(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]);
 return m;}

// ---- orbit controls (z-up, like the reference GGUI camera) ----
const ctl={target:[0,0,0.5],az:0.8,el:0.5,dist:6};
function camEye(){const ce=Math.cos(ctl.el),se=Math.sin(ctl.el);
 return [ctl.target[0]+ctl.dist*ce*Math.cos(ctl.az),
         ctl.target[1]+ctl.dist*ce*Math.sin(ctl.az),
         ctl.target[2]+ctl.dist*se];}
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
 btn:(e.button===2||e.shiftKey)?'pan':'orbit'}; e.preventDefault();});
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 drag.x=e.clientX; drag.y=e.clientY;
 if(drag.btn==='orbit'){ctl.az-=dx*0.008;
  ctl.el=Math.min(1.55,Math.max(-1.55,ctl.el+dy*0.008));}
 else{const eye=camEye(), z=vNorm(vSub(eye,ctl.target));
  const x=vNorm(vCross([0,0,1],z)), y=vCross(z,x);
  const s=ctl.dist*0.0016;
  for(let k=0;k<3;k++) ctl.target[k]+=(-dx*x[k]+dy*y[k])*s;}});
addEventListener('mouseup',()=>{drag=null;});
canvas.addEventListener('contextmenu',e=>e.preventDefault());
canvas.addEventListener('wheel',e=>{e.preventDefault();
 ctl.dist*=Math.exp(e.deltaY*0.001);
 ctl.dist=Math.min(200,Math.max(0.05,ctl.dist));},{passive:false});

// ---- shaders ----
function compile(vsrc,fsrc){
 function sh(type,src){const s=gl.createShader(type);
  gl.shaderSource(s,src); gl.compileShader(s);
  if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
   throw new Error(gl.getShaderInfoLog(s));
  return s;}
 const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vsrc));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fsrc));
 gl.linkProgram(p);
 if(!gl.getProgramParameter(p,gl.LINK_STATUS))
  throw new Error(gl.getProgramInfoLog(p));
 return p;}
const progPts=gl&&compile(
 'attribute vec3 aPos; attribute vec3 aCol; uniform mat4 uMVP;'+
 'uniform float uPx; varying vec3 vCol;'+
 'void main(){gl_Position=uMVP*vec4(aPos,1.0);'+
 ' gl_PointSize=clamp(uPx/gl_Position.w,1.0,64.0); vCol=aCol;}',
 'precision mediump float; varying vec3 vCol;'+
 'void main(){vec2 d=gl_PointCoord-vec2(0.5);'+
 ' if(dot(d,d)>0.25) discard; gl_FragColor=vec4(vCol,1.0);}');
const progMesh=gl&&compile(
 'attribute vec3 aPos; attribute vec3 aCol; attribute vec3 aNrm;'+
 'uniform mat4 uMVP; varying vec3 vCol; varying vec3 vNrm;'+
 'void main(){gl_Position=uMVP*vec4(aPos,1.0); vCol=aCol; vNrm=aNrm;}',
 'precision mediump float; varying vec3 vCol; varying vec3 vNrm;'+
 'uniform vec3 uLight;'+
 'void main(){float d=abs(dot(normalize(vNrm),uLight));'+
 ' gl_FragColor=vec4(vCol*(0.35+0.65*d),1.0);}');
const progLine=gl&&compile(
 'attribute vec3 aPos; uniform mat4 uMVP;'+
 'void main(){gl_Position=uMVP*vec4(aPos,1.0);}',
 'precision mediump float; uniform vec3 uCol;'+
 'void main(){gl_FragColor=vec4(uCol,1.0);}');

function makeBuf(data){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW); return b;}
const boundAttrs=[];
function bindAttr(prog,name,buf){const loc=gl.getAttribLocation(prog,name);
 gl.bindBuffer(gl.ARRAY_BUFFER,buf); gl.enableVertexAttribArray(loc);
 gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0); boundAttrs.push(loc);}
// stale enabled arrays from another program's locations break draws
function flushAttrs(){while(boundAttrs.length)
 gl.disableVertexAttribArray(boundAttrs.pop());}

// ---- scene state ----
let pts=null;         // {buf,colBuf,n}
let mesh=null;        // {buf,colBuf,nrmBuf,n}
let lines=[];         // [{buf,n,col:[r,g,b]}]
let version=-1, radius=0.025;
const hex=c=>[(c>>16&255)/255,(c>>8&255)/255,(c&255)/255];
function freeLines(){for(const l of lines) gl.deleteBuffer(l.buf); lines=[];}
function setPoints(xyz,col){
 if(pts){gl.deleteBuffer(pts.buf); gl.deleteBuffer(pts.colBuf);}
 const n=xyz.length/3;
 if(!col){col=new Float32Array(xyz.length);
  for(let i=0;i<n;i++){col[i*3]=0.29;col[i*3+1]=0.64;col[i*3+2]=1.0;}}
 pts={buf:makeBuf(xyz),colBuf:makeBuf(col),n};}
function setMesh(v,col){
 if(mesh){gl.deleteBuffer(mesh.buf); gl.deleteBuffer(mesh.colBuf);
  gl.deleteBuffer(mesh.nrmBuf);}
 const n=v.length/3;
 if(!col){col=new Float32Array(v.length);
  for(let i=0;i<n;i++){col[i*3]=0.53;col[i*3+1]=0.67;col[i*3+2]=0.6;}}
 const nrm=new Float32Array(v.length);   // flat per-face normals
 for(let t=0;t+9<=v.length;t+=9){
  const ux=v[t+3]-v[t],uy=v[t+4]-v[t+1],uz=v[t+5]-v[t+2];
  const wx=v[t+6]-v[t],wy=v[t+7]-v[t+1],wz=v[t+8]-v[t+2];
  let nx=uy*wz-uz*wy, ny=uz*wx-ux*wz, nz=ux*wy-uy*wx;
  const l=Math.hypot(nx,ny,nz)||1; nx/=l;ny/=l;nz/=l;
  for(let k=0;k<3;k++){nrm[t+k*3]=nx;nrm[t+k*3+1]=ny;nrm[t+k*3+2]=nz;}}
 mesh={buf:makeBuf(v),colBuf:makeBuf(col),nrmBuf:makeBuf(nrm),n};}
function addLines(v,color){lines.push({buf:makeBuf(v),n:v.length/3,
 col:hex(color)});}

// ---- static helpers: ground grid + axes, rebuilt once ----
(function(){const seg=[];
 for(let i=-10;i<=10;i++){seg.push(i,-10,0,i,10,0,-10,i,0,10,i,0);}
 addLines(new Float32Array(seg),0x1d2435);
 lines[0].keep=true;})();
const axes=[[0x883333,[1,0,0]],[0x338833,[0,1,0]],[0x333388,[0,0,1]]];
for(const[c,d]of axes){addLines(new Float32Array([0,0,0,
 d[0]*.5,d[1]*.5,d[2]*.5]),c); lines[lines.length-1].keep=true;}
const nKeep=lines.length;
function clearLines(){for(let i=nKeep;i<lines.length;i++)
 gl.deleteBuffer(lines[i].buf); lines.length=nKeep;}

async function poll(){
 try{
  const v=await (await fetch('/version')).json();
  if(v.version!==version){
   version=v.version;
   const buf=await (await fetch('/scene.bin')).arrayBuffer();
   parse(buf);
  }
  msg.textContent='live · v'+version;
 }catch(e){msg.textContent='disconnected: '+e;}
 setTimeout(poll,100);
}
function parse(buf){
 const dv=new DataView(buf); let off=8;
 let xyz=null,col=null,mv=null,mc=null;
 clearLines();
 let nPar=0,nTri=0;
 while(off+8<=buf.byteLength){
  const tag=dv.getUint32(off,true), len=dv.getUint32(off+4,true); off+=8;
  const f=new Float32Array(buf.slice(off,off+len)); off+=len;
  if(tag===1){xyz=f;nPar=f.length/3;} else if(tag===2){col=f;}
  else if(tag===3){mv=f;nTri=f.length/9;} else if(tag===4){mc=f;}
  else if(tag===5){addLines(f,0x888888);}
  else if(tag===6){addLines(f,0x39d98a);}
  else if(tag===7){
   const T=[f[10],f[11],f[12]];
   for(let a=0;a<3;a++){
    const tip=[T[0]+f[1+a]*0.3,T[1]+f[4+a]*0.3,T[2]+f[7+a]*0.3];
    addLines(new Float32Array([T[0],T[1],T[2],tip[0],tip[1],tip[2]]),
             [0xff5555,0x55ff66,0x5588ff][a]);
   }
   if(document.getElementById('lock_pos_drone').checked)
    ctl.target=[T[0],T[1],T[2]];
  }
  else if(tag===8){
   const n=f[1]; const seg=new Float32Array(Math.max(0,(n-1))*6);
   for(let i=0;i+1<n;i++){for(let k=0;k<3;k++){
     seg[i*6+k]=f[2+i*3+k]; seg[i*6+3+k]=f[2+(i+1)*3+k];}}
   addLines(seg,0x4aa3ff);
  }
  else if(tag===9){radius=f[0];}
 }
 if(xyz) setPoints(xyz,col);
 if(mv) setMesh(mv,mc);
 document.getElementById('stats').textContent=
   nPar+' particles · '+nTri+' triangles';
}
async function pushOptions(){
 const o={};
 for(const id of ['disp_particles','disp_mesh','enable_mesher',
                  'lock_pos_drone','enable_slice_z'])
  o[id]=document.getElementById(id).checked;
 for(const id of ['particle_radius','slice_z'])
  o[id]=parseFloat(document.getElementById(id).value);
 document.getElementById('rv').textContent=o.particle_radius;
 document.getElementById('sv').textContent=o.slice_z;
 radius=o.particle_radius;
 await fetch('/options',{method:'POST',body:JSON.stringify(o)});
}
for(const el of document.querySelectorAll('#panel input'))
 el.addEventListener('input',pushOptions);

function draw(){
 requestAnimationFrame(draw);
 if(!gl) return;
 const w=innerWidth*devicePixelRatio, h=innerHeight*devicePixelRatio;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.063,0.075,0.102,1);
 gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const proj=mPersp(Math.PI/3,w/h,0.01,500);
 const eye=camEye();
 const mvp=mMul(proj,mLookAt(eye,ctl.target,[0,0,1]));
 // lines
 gl.useProgram(progLine);
 gl.uniformMatrix4fv(gl.getUniformLocation(progLine,'uMVP'),false,mvp);
 for(const l of lines){
  gl.uniform3fv(gl.getUniformLocation(progLine,'uCol'),l.col);
  bindAttr(progLine,'aPos',l.buf);
  gl.drawArrays(gl.LINES,0,l.n); flushAttrs();}
 // mesh (flat-shaded)
 if(mesh&&document.getElementById('disp_mesh').checked){
  gl.useProgram(progMesh);
  gl.uniformMatrix4fv(gl.getUniformLocation(progMesh,'uMVP'),false,mvp);
  gl.uniform3fv(gl.getUniformLocation(progMesh,'uLight'),
                vNorm([0.35,0.5,0.8]));
  bindAttr(progMesh,'aPos',mesh.buf);
  bindAttr(progMesh,'aCol',mesh.colBuf);
  bindAttr(progMesh,'aNrm',mesh.nrmBuf);
  gl.drawArrays(gl.TRIANGLES,0,mesh.n); flushAttrs();}
 // points (size-attenuated round sprites)
 if(pts&&document.getElementById('disp_particles').checked){
  gl.useProgram(progPts);
  gl.uniformMatrix4fv(gl.getUniformLocation(progPts,'uMVP'),false,mvp);
  // world radius -> pixels at clip w=1: r * (h/2) * proj[5]
  gl.uniform1f(gl.getUniformLocation(progPts,'uPx'),
               radius*h*0.5*1.7320508);
  bindAttr(progPts,'aPos',pts.buf);
  bindAttr(progPts,'aCol',pts.colBuf);
  gl.drawArrays(gl.POINTS,0,pts.n); flushAttrs();}
}
draw();
poll();
</script></body></html>
"""
