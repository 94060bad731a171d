"""Head-node web dashboard: JSON state APIs + one static HTML page.

The reference ships a 25k-line aiohttp + React dashboard
(dashboard/head.py:200-215 autoloads module subclasses; the TS frontend
renders GCS state). Everything it displays already exists here as Python
state — controller tables, task events, the log buffer, prometheus text —
so this dashboard is a thin read-only HTTP layer over those
sources plus a single self-contained HTML page (no build step, no node_modules;
the page polls the JSON endpoints).

Endpoints:
  GET /                      HTML overview (auto-refreshing)
  GET /api/cluster           summary: nodes, resources, job, uptime
  GET /api/nodes             state API list_nodes
  GET /api/tasks[?limit=]    state API list_tasks
  GET /api/actors            state API list_actors
  GET /api/objects           state API list_objects
  GET /api/placement_groups  state API list_placement_groups
  GET /api/task_summary      per-(name,state) counts
  GET /api/logs[?node_id=&wid=&after_seq=&limit=]   log buffer tail
  GET /api/timeline          chrome://tracing JSON of task events + buffered
                             tracing spans (serving + training rows)
  GET /api/metrics_history[?limit=&since=]   gauge-suite timeseries ring
  GET /api/llm[?steps=]      LLM engine panel: stats, flight recorder,
                             dead letters, shed ring + overload counters,
                             per named engine actor
  GET /api/fleet[?steps=]    fleet observability: per-replica time ledger
                             (host-schedule/device/commit/fabric/idle
                             decomposition of step wall), goodput, MFU,
                             merged cross-replica request histograms +
                             percentiles (observability.fleet_snapshot)
  GET /api/serve             Serve control-plane panel: per-deployment
                             replica lifecycle states (STARTING/RUNNING/
                             DRAINING), transition history, drain durations,
                             drained/migrated counts, autoscaling signals
  GET /api/train[?rounds=]   training-run panel: round records, per-phase
                             breakdown, straggler flags, per recent fit()
  GET /metrics               prometheus text exposition (runtime gauges,
                             LLM engine gauges, AND serve replica-state
                             gauges refreshed at scrape time)
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_START = time.time()

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray-tpu-torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.5rem;background:#fafafa;color:#222}
 h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.4rem}
 table{border-collapse:collapse;width:100%;background:#fff;font-size:.85rem}
 th,td{border:1px solid #ddd;padding:.3rem .5rem;text-align:left}
 th{background:#f0f0f0} .mono{font-family:ui-monospace,monospace}
 #cluster{background:#fff;border:1px solid #ddd;padding:.6rem 1rem}
 .ok{color:#0a7d33}.bad{color:#c22}
</style></head><body>
<h1>ray-tpu-torch dashboard</h1>
<div id="cluster">loading…</div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Task summary</h2><table id="tasks"></table>
<h2>Serve deployments</h2><div id="serve">none</div>
<h2>LLM engines</h2><div id="llm">none</div>
<h2>Fleet ledger</h2><div id="fleet">none</div>
<h2>Train runs</h2><div id="train">none</div>
<h2>History <span id="hist_legend" style="font-size:.75rem;font-weight:normal"></span></h2>
<canvas id="hist" width="900" height="160"
  style="background:#fff;border:1px solid #ddd;width:100%;max-width:900px"></canvas>
<h2>Recent logs</h2><pre id="logs" class="mono"
  style="background:#fff;border:1px solid #ddd;padding:.6rem;max-height:20rem;overflow:auto"></pre>
<script>
const HIST_KEYS=[['tasks:RUNNING','#0a7d33'],['scheduler_queued','#c22'],
                 ['object_store_used','#1565c0']];
function drawHistory(samples){
  const cv=document.getElementById('hist'),ctx=cv.getContext('2d');
  ctx.clearRect(0,0,cv.width,cv.height);
  if(!samples.length)return;
  document.getElementById('hist_legend').innerHTML=HIST_KEYS.map(
    ([k,c])=>`<span style="color:${c}">■ ${esc(k)}</span>`).join(' ');
  for(const [key,color] of HIST_KEYS){
    const ys=samples.map(s=>s.v[key]??0);
    const max=Math.max(...ys,1e-9);
    ctx.strokeStyle=color;ctx.beginPath();
    ys.forEach((y,i)=>{
      const px=i*(cv.width-10)/Math.max(ys.length-1,1)+5;
      const py=cv.height-8-(y/max)*(cv.height-16);
      i?ctx.lineTo(px,py):ctx.moveTo(px,py);
    });
    ctx.stroke();
  }
}
async function j(u){const r=await fetch(u);return r.json()}
function renderLLM(engines){
  const el=document.getElementById('llm');
  if(!engines.length){el.textContent='none';return}
  el.innerHTML=engines.map(e=>{
    if(e.error)return `<p><b>${esc(e.name)}</b> <span class=bad>${esc(e.error)}</span></p>`;
    const m=e.metrics,fr=e.flight_record;
    const head=`<p><b class=mono>${esc(e.name)}</b> · `+
      `${m.wedged?'<span class=bad>WEDGED</span>':'<span class=ok>healthy</span>'} · `+
      ((m.tensor_parallel_size||1)>1?`tp ${m.tensor_parallel_size} · `+
        `pool ${(m.kv_pool_bytes_per_shard/1048576).toFixed(1)}MiB/card `+
        `(${(m.kv_pool_bytes/1048576).toFixed(1)} total) · `:'')+
      `steps ${m.steps} · decode tok ${m.decode_tokens} · `+
      `occupancy ${(m.mean_occupancy??0).toFixed(2)} · `+
      `cache ${(m.cache_utilization??0).toFixed(2)} · `+
      `hit rate ${(m.prefix_cache_hit_rate??0).toFixed(2)} · `+
      `queue ${m.queue_depth} · preempt ${m.num_preemptions} · `+
      `dead letters ${m.num_dead_letters}`+
      ((m.shed_requests||m.expired_requests||m.fabric_timeouts)?
        ` · <span class=bad>shed ${m.shed_requests??0}</span>`+
        ` · expired ${m.expired_requests??0}`+
        (m.fabric_timeouts?` · fabric timeouts ${m.fabric_timeouts}`:''):'')+
      (m.async_scheduling?` · <b>async</b> host gap `+
        `${m.host_gap_mean_s==null?'—':(1e6*m.host_gap_mean_s).toFixed(0)+'µs'} mean`+
        ((e.latency_percentiles?.host_gap_s?.p50)!=null?
          ` / ${(1e6*e.latency_percentiles.host_gap_s.p50).toFixed(0)}µs p50`:'')+
        ` · inflight ${m.inflight_steps}`:'')+`</p>`+
      (m.kv_fabric&&m.kv_fabric!=='off'?
        `<p style="font-size:.8rem">kv fabric <b class=mono>${esc(m.kv_fabric)}</b>`+
        (m.engine_role&&m.engine_role!=='unified'?` (${esc(m.engine_role)} role)`:'')+
        ` · hit rate ${(m.fabric_hit_rate??0).toFixed(2)} · `+
        `spilled ${m.fabric_spill_blocks} / restored ${m.fabric_restore_blocks} blocks · `+
        `store ${((m.fabric_store?.bytes_used??0)/1048576).toFixed(1)}/`+
        `${((m.fabric_store?.byte_budget??0)/1048576).toFixed(1)}MiB `+
        `(${m.fabric_store?.num_blocks??0} blocks, ${m.fabric_store?.evictions??0} evictions)</p>`:'');
    const steps=(fr.steps||[]).slice(-12).map(s=>
      `<tr><td>${s.step}</td><td>${esc(s.phase)}${s.chained?'⤳':''}</td><td>${s.batch_size}</td>`+
      `<td>${s.tokens_in}/${s.tokens_out}</td><td>${s.cache_hit_tokens}</td>`+
      `<td>${s.preempted}</td><td>${(1e3*s.duration_s).toFixed(1)}ms</td>`+
      `<td>${s.host_gap_s==null?'—':(1e6*s.host_gap_s).toFixed(0)+'µs'}</td></tr>`).join('');
    const stepTable=steps?`<table><tr><th>step</th><th>phase</th><th>batch</th>`+
      `<th>tok in/out</th><th>cache hits</th><th>preempt</th><th>dur</th><th>gap</th></tr>${steps}</table>`:'';
    const compiles=(fr.compile_events||[]).map(c=>
      `${esc(c.program)}[${c.bucket}] ${c.compile_s.toFixed(2)}s`).join(' · ');
    const fails=(fr.failures||[]).slice(-5).map(f=>
      `<li class=bad>step ${f.step} ${esc(f.action)}: ${esc(f.error)}</li>`).join('');
    const sheds=(e.shed_requests||[]).slice(-5).map(s=>
      `${esc(s.request_id??'?')} ${esc(s.reason??'')} (queue ${s.queue_len??0}, `+
      `retry ${((s.retry_after_s??0)*1e3).toFixed(0)}ms)`).join(' · ');
    return head+stepTable+
      (compiles?`<p style="font-size:.8rem">warmup compiles: ${compiles}</p>`:'')+
      (sheds?`<p style="font-size:.8rem" class=bad>recent sheds: ${sheds}</p>`:'')+
      (fails?`<ul style="font-size:.8rem">${fails}</ul>`:'');
  }).join('<hr>');
}
function renderFleet(f){
  const el=document.getElementById('fleet');
  const reps=Object.entries(f.replicas||{});
  if(!reps.length){el.textContent='none';return}
  const cols=['idle_s','prefill_s','fabric_wait_s','host_schedule_s',
              'device_s','commit_s','other_s','loop_s'];
  const pct=x=>x==null?'—':(100*x).toFixed(1)+'%';
  const rows=reps.map(([name,r])=>{
    if(r.error)return `<tr><td class=mono>${esc(name)}</td>`+
      `<td colspan=${cols.length+4} class=bad>${esc(r.error)}</td></tr>`;
    const L=r.ledger;
    return `<tr><td class=mono>${esc(name)}</td>`+
      `<td>${L.wall_s.toFixed(2)}s</td>`+
      cols.map(c=>`<td>${pct((L.fractions||{})[c])}</td>`).join('')+
      `<td>${pct(L.coverage)}</td>`+
      `<td>${L.goodput_tokens_per_s.toFixed(1)}</td>`+
      `<td>${L.mfu==null?'—':pct(L.mfu)}</td></tr>`;
  }).join('');
  const fl=f.fleet||{};
  const p=f.percentiles||{};
  const pc=(m,q)=>p[m]?.[q]==null?'—':(1e3*p[m][q]).toFixed(1)+'ms';
  el.innerHTML=`<table><tr><th>replica</th><th>wall</th>`+
    cols.map(c=>`<th>${esc(c.replace(/_s$/,''))}</th>`).join('')+
    `<th>Σ/wall</th><th>tok/s</th><th>MFU</th></tr>${rows}</table>`+
    `<p style="font-size:.8rem">fleet: ${fl.replicas??0} replicas · `+
    `${(fl.goodput_tokens_per_s??0).toFixed(1)} tok/s · `+
    `top columns ${(fl.bottlenecks||[]).slice(0,3).map(esc).join(' → ')||'—'} · `+
    `ttft p50/p99 ${pc('llm_request_ttft_seconds','p50')}/${pc('llm_request_ttft_seconds','p99')} · `+
    `e2e p99 ${pc('llm_request_e2e_seconds','p99')}</p>`;
}
function renderServe(apps){
  const el=document.getElementById('serve');
  if(apps.error){el.innerHTML=`<span class=bad>${esc(apps.error)}</span>`;return}
  const rows=[];
  for(const [app,deps] of Object.entries(apps)){
    for(const [dep,d] of Object.entries(deps)){
      const sc=d.state_counts||{};
      const states=['STARTING','RUNNING','DRAINING'].map(s=>{
        const n=sc[s]||0;
        return n?`${s.toLowerCase()} ${s==='DRAINING'?'<span class=bad>'+n+'</span>':n}`:'';
      }).filter(Boolean).join(' · ')||'no replicas';
      const ds=d.drain_seconds||{};
      const hist=(d.history||[]).slice(-6).map(h=>
        `${esc(h.tag.split('#').pop())}:${esc(h.state)}`).join(' → ');
      const sig=d.autoscaling_signals;
      rows.push(`<p><b class=mono>${esc(app)}#${esc(dep)}</b> · `+
        `${d.status==='HEALTHY'?'<span class=ok>HEALTHY</span>':'<span class=bad>'+esc(d.status)+'</span>'} · `+
        `target ${d.target_replicas} · ${states} · `+
        `drained ${d.num_drained_replicas} replicas / ${d.num_migrated_requests} migrated streams`+
        (ds.p50!=null?` · drain p50 ${(ds.p50*1e3).toFixed(0)}ms p99 ${(ds.p99*1e3).toFixed(0)}ms`:'')+
        (sig?`<br><span style="font-size:.8rem">slo window: queue p99 ${sig.queue_time_p99_s==null?'—':(sig.queue_time_p99_s*1e3).toFixed(1)+'ms'} · `+
          `ttft p99 ${sig.ttft_p99_s==null?'—':(sig.ttft_p99_s*1e3).toFixed(1)+'ms'} · `+
          `backlog ${sig.prefill_backlog_tokens} tok</span>`:'')+
        (hist?`<br><span style="font-size:.8rem" class=mono>${hist}</span>`:'')+
        `</p>`);
    }
  }
  el.innerHTML=rows.join('')||'none';
}
function renderTrain(runs){
  const el=document.getElementById('train');
  if(!runs.length){el.textContent='none';return}
  el.innerHTML=runs.map(r=>{
    const ps=r.phase_stats||{};
    const phases=Object.entries(ps).map(([p,s])=>
      `${esc(p)} ${(1e3*s.median).toFixed(1)}ms`).join(' · ');
    const head=`<p><b class=mono>${esc(r.name)}</b> [${esc(r.run_id)}] · `+
      `${r.error?'<span class=bad>'+esc(r.error)+'</span>'
               :(r.finished?'<span class=ok>finished</span>':'running')} · `+
      `${r.num_workers} workers · rounds ${r.rounds_total} · `+
      `samples ${r.samples_total} · `+
      `straggler rounds ${r.straggler_rounds?'<span class=bad>'+r.straggler_rounds+'</span>':'0'}`+
      `</p><p style="font-size:.8rem">phase medians: ${phases||'n/a'}</p>`;
    const rounds=(r.rounds||[]).slice(-8).map(x=>
      `<tr><td>${x.round}</td><td>${(1e3*x.duration_s).toFixed(1)}ms</td>`+
      `<td>${x.samples}</td>`+
      `<td>${Object.entries(x.phase_stats||{}).map(([p,s])=>
          `${esc(p)} ${(1e3*s.max).toFixed(1)}`).join(' ')}</td>`+
      `<td>${(x.stragglers||[]).map(s=>
          `<span class=bad>rank ${s.rank}: ${esc(s.phase)}</span>`).join(' ')||'—'}</td></tr>`).join('');
    const table=rounds?`<table><tr><th>round</th><th>wall</th><th>samples</th>`+
      `<th>phase max (ms)</th><th>stragglers</th></tr>${rounds}</table>`:'';
    return head+table;
  }).join('<hr>');
}
function esc(s){return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
  .replace(/>/g,'&gt;').replace(/"/g,'&quot;')}
function fill(id, rows, cols){
  const t=document.getElementById(id);
  if(!rows.length){t.innerHTML='<tr><td>none</td></tr>';return}
  cols=cols||Object.keys(rows[0]);
  t.innerHTML='<tr>'+cols.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>'+
    rows.map(r=>'<tr>'+cols.map(c=>'<td>'+esc(JSON.stringify(r[c]??''))+'</td>').join('')+'</tr>').join('');
}
async function refresh(){
  try{
    const c=await j('/api/cluster');
    document.getElementById('cluster').innerHTML=
      `job <b class=mono>${c.job_id}</b> · ${c.alive_nodes}/${c.nodes} nodes alive · `+
      `uptime ${c.uptime_s.toFixed(0)}s · resources `+
      `<span class=mono>${JSON.stringify(c.resources_available)}</span> / `+
      `<span class=mono>${JSON.stringify(c.resources_total)}</span>`;
    fill('nodes', await j('/api/nodes'),
         ['node_id','state','resources_total','resources_available','is_head_node']);
    fill('actors', await j('/api/actors'),
         ['actor_id','class_name','state','name','num_restarts']);
    const s=await j('/api/task_summary');
    fill('tasks', Object.entries(s).map(([k,v])=>({task:k,count:v})));
    renderServe(await j('/api/serve'));
    renderLLM(await j('/api/llm?steps=12'));
    renderFleet(await j('/api/fleet'));
    renderTrain(await j('/api/train?rounds=8'));
    const logs=await j('/api/logs?limit=200');
    document.getElementById('logs').textContent=
      logs.map(l=>`(pid=${l.pid}, node=${l.hostname}) ${l.line}`).join('\\n');
    drawHistory(await j('/api/metrics_history?limit=720'));
  }catch(e){document.getElementById('cluster').innerHTML=
      '<span class=bad>refresh failed: '+e+'</span>'}
  setTimeout(refresh, 2000);
}
refresh();
</script></body></html>"""


def _serve_snapshot(runtime) -> dict:
    """The controller's replica-lifecycle observability plus drain-duration
    percentiles from the serve_replica_drain_seconds histogram (same
    in-process registry read as the LLM latency panel). Controller
    failures degrade to an error field, never a 500."""
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    existing = runtime.controller.get_named_actor(
        CONTROLLER_NAME, runtime.namespace
    )
    if existing is None:
        return {}
    import ray_tpu_torch
    from ray_tpu_torch.actor import ActorHandle
    from ray_tpu_torch.util.metrics import histogram_percentile

    try:
        obs = ray_tpu_torch.get(
            ActorHandle(
                existing, "ServeControllerActor"
            ).get_observability.remote(),
            timeout=2.0,
        )
    except Exception as exc:
        return {"error": repr(exc)}
    for app_name, deps in obs.items():
        for dep_name, dep in deps.items():
            tags = {"app": app_name, "deployment": dep_name}
            try:
                dep["drain_seconds"] = {
                    "p50": histogram_percentile(
                        "serve_replica_drain_seconds", 50.0, tags
                    ),
                    "p99": histogram_percentile(
                        "serve_replica_drain_seconds", 99.0, tags
                    ),
                }
            except KeyError:
                dep["drain_seconds"] = {"p50": None, "p99": None}
    return obs


def _llm_engines_snapshot(runtime, steps_limit: int = 32) -> list:
    """One row per live named LLM engine actor: metrics(), the tail of the
    flight recorder, and the dead-letter ring. Engine failures degrade to
    an error field on the row, never a 500 on the panel."""
    from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

    import ray_tpu_torch

    # One combined RPC per engine, all fired up front and collected
    # against one shared deadline: a busy engine's lock is awaited once,
    # and N engines cost the panel max-of-N, not sum-of-N.
    pending = []
    for name, namespace in list_llm_engine_actors(runtime):
        row = {"name": name}
        try:
            handle = ray_tpu_torch.get_actor(name, namespace=namespace)
            pending.append(
                (row, handle.observability_snapshot.remote(steps_limit))
            )
        except Exception as exc:
            row["error"] = repr(exc)
            pending.append((row, None))
    deadline = time.monotonic() + 2.0
    rows = []
    for row, ref in pending:
        if ref is not None:
            try:
                row.update(
                    ray_tpu_torch.get(
                        ref, timeout=max(deadline - time.monotonic(), 0.05)
                    )
                )
                row["latency_percentiles"] = _llm_latency_percentiles(
                    row.get("metrics", {}).get("engine_id")
                )
            except Exception as exc:
                row["error"] = repr(exc)
        rows.append(row)
    return rows


def _llm_latency_percentiles(engine_id) -> dict:
    """p50/p99 of the serving SLO trio + queue time, interpolated from the
    request histograms the engine already exports (util.metrics
    histogram_percentile — same helper the loadgen SLO gate reads). Engines
    run in-process, so the panel reads the shared registry directly; a
    series that has not observed yet reports null, never an error."""
    from ray_tpu_torch.util.metrics import histogram_percentile

    out: dict = {}
    if engine_id is None:
        return out
    tags = {"engine": engine_id}
    for label, name in (
        ("ttft_s", "llm_request_ttft_seconds"),
        ("tpot_s", "llm_request_time_per_output_token_seconds"),
        ("queue_s", "llm_request_queue_time_seconds"),
        ("e2e_s", "llm_request_e2e_seconds"),
        ("host_gap_s", "llm_engine_step_host_gap_seconds"),
    ):
        try:
            out[label] = {
                "p50": histogram_percentile(name, 50.0, tags),
                "p99": histogram_percentile(name, 99.0, tags),
            }
        except KeyError:
            out[label] = {"p50": None, "p99": None}
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "ray-tpu-torch-dashboard"

    def log_message(self, *args):  # silence per-request stderr noise
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj) -> None:
        self._send(200, json.dumps(obj, default=str).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        try:
            self._route()
        except BrokenPipeError:
            pass
        except Exception as exc:  # surface handler bugs as 500s, not hangs
            try:
                self._send(500, repr(exc).encode(), "text/plain")
            except Exception:
                pass

    def _route(self) -> None:
        from ray_tpu_torch.util.state import api as state
        from ray_tpu_torch.util import metrics

        runtime = self.server.runtime  # type: ignore[attr-defined]
        parsed = urllib.parse.urlparse(self.path)
        q = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        path = parsed.path
        limit = int(q.get("limit", 1000))
        if path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif path == "/api/cluster":
            nodes = list(runtime.controller.nodes.values())
            total: dict = {}
            avail: dict = {}
            for node in nodes:
                for key, val in node.total.items():
                    total[key] = total.get(key, 0) + val
                for key, val in node.available.items():
                    avail[key] = avail.get(key, 0) + val
            self._json(
                {
                    "job_id": runtime.job_id.hex(),
                    "nodes": len(nodes),
                    "alive_nodes": sum(node.alive for node in nodes),
                    "resources_total": total,
                    "resources_available": avail,
                    "uptime_s": time.time() - _START,
                }
            )
        elif path == "/api/nodes":
            self._json(state.list_nodes(limit=limit))
        elif path == "/api/tasks":
            self._json(state.list_tasks(limit=limit))
        elif path == "/api/actors":
            self._json(state.list_actors(limit=limit))
        elif path == "/api/objects":
            self._json(state.list_objects(limit=limit))
        elif path == "/api/placement_groups":
            self._json(state.list_placement_groups(limit=limit))
        elif path == "/api/task_summary":
            self._json(state.summarize_tasks())
        elif path == "/api/logs":
            self._json(
                runtime.logs.tail(
                    node_id=q.get("node_id"),
                    wid=int(q["wid"]) if "wid" in q else None,
                    after_seq=int(q["after_seq"]) if "after_seq" in q else None,
                    limit=limit,
                )
            )
        elif path == "/api/timeline":
            from ray_tpu_torch.util import tracing

            self._json(
                runtime.task_events.chrome_trace()
                + tracing.chrome_spans(runtime)
            )
        elif path == "/api/traces":
            from ray_tpu_torch.util import tracing

            self._json(
                tracing.traces(trace_id=q.get("trace_id"), runtime=runtime)
            )
        elif path == "/api/metrics_history":
            sampler = getattr(runtime, "_metrics_sampler", None)
            history = getattr(sampler, "history", None)
            self._json(
                history.snapshot(
                    limit=min(limit, 720), since=float(q.get("since", 0))
                )
                if history is not None
                else []
            )
        elif path == "/api/llm":
            self._json(
                _llm_engines_snapshot(
                    runtime, steps_limit=int(q.get("steps", 32))
                )
            )
        elif path == "/api/fleet":
            from ray_tpu_torch.observability import fleet_snapshot

            self._json(
                fleet_snapshot(
                    runtime, steps_limit=int(q.get("steps", 512))
                )
            )
        elif path == "/api/serve":
            self._json(_serve_snapshot(runtime))
        elif path == "/api/train":
            from ray_tpu_torch.train.observability import list_runs

            self._json(
                list_runs(
                    limit=int(q.get("limit", 8)),
                    rounds_limit=int(q.get("rounds", 8)),
                )
            )
        elif path == "/metrics":
            from ray_tpu_torch.util.runtime_metrics import (
                sample_llm_engine_metrics,
                sample_runtime_metrics,
                sample_serve_metrics,
            )

            sample_runtime_metrics(runtime)  # scrape-time freshness
            sample_llm_engine_metrics(runtime)  # idle engines stay current
            sample_serve_metrics(runtime)  # replica lifecycle-state gauges
            self._send(200, metrics.prometheus_text().encode(), "text/plain")
        else:
            self._send(404, b"not found", "text/plain")


class DashboardServer:
    """Threaded HTTP server bound to the head; read-only over runtime state."""

    def __init__(self, runtime, host: str = "127.0.0.1", port: int = 8265):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.runtime = runtime  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dashboard", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


def start_dashboard(runtime, host: str = "127.0.0.1", port: int = 8265) -> DashboardServer:
    return DashboardServer(runtime, host, port)
