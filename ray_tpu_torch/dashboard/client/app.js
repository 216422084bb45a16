/* ray_tpu_torch dashboard SPA.
 *
 * Hash-routed single-page app over the JSON API served by
 * ray_tpu_torch/dashboard/__init__.py (reference: dashboard/client/src — a
 * React app over the head's REST API; this is the no-build-step
 * equivalent: plain ES modules-free JS, zero dependencies).
 *
 * Pages: overview (resource cards + sparklines), nodes/workers/actors/
 * tasks/placement_groups tables, per-task and per-actor drill-down,
 * jobs, serve apps, log tail, and a flamegraph viewer over the folded
 * stacks the sampling profiler returns.
 */
"use strict";

const $ = (sel) => document.querySelector(sel);

function esc(s) {
  return String(s).replace(/[&<>"']/g, (c) => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  })[c]);
}

async function getJSON(url) {
  const r = await fetch(url);
  if (!r.ok) throw new Error(`${url}: HTTP ${r.status} ${await r.text()}`);
  return r.json();
}

// ------------------------------------------------------------- router

const PAGES = {};
let refreshTimer = null;

function route() {
  const hash = location.hash.replace(/^#\/?/, "") || "overview";
  const [page, ...rest] = hash.split("/");
  const fn = PAGES[page] || PAGES.overview;
  document.querySelectorAll("nav a").forEach((a) => {
    a.classList.toggle("active", a.dataset.page === page);
  });
  if (refreshTimer) { clearInterval(refreshTimer); refreshTimer = null; }
  const render = async (force) => {
    // Don't yank a form control out from under the user: the refresh
    // replaces #page wholesale, which would wipe in-progress typing.
    const el = document.activeElement;
    if (!force && el && $("#page").contains(el) &&
        ["INPUT", "SELECT", "TEXTAREA"].includes(el.tagName)) return;
    try {
      await fn(rest.join("/"));
    } catch (e) {
      $("#page").innerHTML =
        `<div class="err-banner">${esc(e.message || e)}</div>`;
    }
  };
  render(true);
  // Live refresh for everything except the (expensive) profiler page.
  if (page !== "profile") refreshTimer = setInterval(render, 3000);
}
window.addEventListener("hashchange", route);
window.addEventListener("load", route);

// ------------------------------------------------------- shared pieces

function statusClass(s) {
  s = String(s).toUpperCase();
  if (["ALIVE", "RUNNING", "SUCCEEDED", "FINISHED", "TERMINATED", "HEALTHY",
       "DEPLOYED"].includes(s)) return "ok";
  if (["PENDING", "RESTARTING", "DEPLOYING", "STOPPED", "NOT_STARTED",
       "UPDATING"].includes(s)) return "warn";
  if (["DEAD", "ERROR", "FAILED", "UNHEALTHY", "DEPLOY_FAILED"].includes(s))
    return "err";
  return "";
}

function cellHTML(kind, col, val) {
  if (val === null || val === undefined) return "";
  if (col === "status" || col === "state")
    return `<span class="status ${statusClass(val)}">${esc(val)}</span>`;
  if (kind === "tasks" && col === "task_id")
    return `<a href="#/task/${encodeURIComponent(val)}">${esc(val)}</a>`;
  if ((kind === "actors" || kind === "tasks") && col === "actor_id" && val)
    return `<a href="#/actor/${encodeURIComponent(val)}">${esc(val)}</a>`;
  if (kind === "workers" && col === "worker_id")
    return `<a href="#/profile/${encodeURIComponent(val)}">${esc(val)}</a>`;
  if (typeof val === "object") return esc(JSON.stringify(val));
  return esc(val);
}

function renderTable(kind, items, filter) {
  if (filter) {
    const f = filter.toLowerCase();
    items = items.filter((it) =>
      JSON.stringify(it).toLowerCase().includes(f));
  }
  if (!items.length) return '<p class="muted">(none)</p>';
  const cols = Object.keys(items[0]);
  let html = "<table><thead><tr>" +
    cols.map((c) => `<th>${esc(c)}</th>`).join("") + "</tr></thead><tbody>";
  for (const it of items.slice(0, 200)) {
    html += "<tr>" + cols.map(
      (c) => `<td>${cellHTML(kind, c, it[c])}</td>`).join("") + "</tr>";
  }
  return html + "</tbody></table>" + (items.length > 200
    ? `<p class="muted">showing 200 of ${items.length}</p>` : "");
}

const tableFilters = {};  // page -> current filter text, survives refresh

function tablePage(kind, title) {
  return async () => {
    const items = await getJSON(`/api/${kind}`);
    const f = tableFilters[kind] || "";
    $("#page").innerHTML =
      `<h1>${esc(title)} <span class="muted">(${items.length})</span></h1>` +
      `<div class="toolbar"><input id="filter" placeholder="filter…" ` +
      `value="${esc(f)}"></div><div id="tbl">` +
      renderTable(kind, items, f) + "</div>";
    $("#filter").addEventListener("input", (e) => {
      tableFilters[kind] = e.target.value;
      $("#tbl").innerHTML = renderTable(kind, items, e.target.value);
    });
  };
}

function spark(points, label, w = 180, h = 40) {
  if (!points.length) return "";
  const max = Math.max(...points, 1e-9), min = Math.min(...points, 0);
  const xs = points.map((p, i) => [
    (i * w) / Math.max(points.length - 1, 1),
    h - 2 - ((p - min) / Math.max(max - min, 1e-9)) * (h - 4)]);
  const path = xs.map(([x, y], i) =>
    (i ? "L" : "M") + x.toFixed(1) + " " + y.toFixed(1)).join(" ");
  return `<figure><svg class="spark" width="${w}" height="${h}">` +
    `<path d="${path}" fill="none" stroke="#2458c5" stroke-width="1.5"/>` +
    `</svg><figcaption>${esc(label)} ` +
    `(now: ${points[points.length - 1].toFixed(1)})</figcaption></figure>`;
}

// --------------------------------------------------------------- pages

PAGES.overview = async () => {
  const [cluster, ts, nodes, actors] = await Promise.all([
    getJSON("/api/cluster"), getJSON("/api/metrics_timeseries"),
    getJSON("/api/nodes"), getJSON("/api/actors"),
  ]);
  const aliveNodes = nodes.filter((n) => n.alive).length;
  const aliveActors = actors.filter(
    (a) => String(a.state).toUpperCase() === "ALIVE").length;
  let html = "<h1>Cluster overview</h1><div class='cards'>";
  html += `<div class="card"><div class="num">${aliveNodes}</div>` +
    `<div class="label">nodes alive</div></div>`;
  html += `<div class="card"><div class="num">${aliveActors}</div>` +
    `<div class="label">actors alive</div></div>`;
  for (const k of Object.keys(cluster.total).sort()) {
    const used = (cluster.total[k] - (cluster.available[k] ?? 0));
    html += `<div class="card"><div class="num">` +
      `${+used.toFixed(2)}<span class="muted">/${cluster.total[k]}</span>` +
      `</div><div class="label">${esc(k)} used</div></div>`;
  }
  html += "</div><h2>Metrics</h2><div class='sparkrow'>";
  for (const [name, pts] of Object.entries(ts.series))
    html += spark(pts, name);
  html += "</div>";
  $("#page").innerHTML = html;
};

PAGES.nodes = tablePage("nodes", "Nodes");
PAGES.workers = tablePage("workers", "Workers");
PAGES.actors = tablePage("actors", "Actors");
PAGES.tasks = tablePage("tasks", "Tasks");
PAGES.placement_groups = tablePage("placement_groups", "Placement groups");
PAGES.objects = tablePage("objects", "Objects");

PAGES.task = async (tid) => {
  const d = await getJSON(`/api/task/${encodeURIComponent(tid)}`);
  $("#page").innerHTML = `<h1>Task <code>${esc(tid)}</code></h1>` +
    "<h2>State</h2><pre>" + esc(JSON.stringify(d.task, null, 2)) + "</pre>" +
    `<h2>Timeline events (${d.events.length})</h2>` +
    renderTable("events", d.events, "");
};

PAGES.actor = async (aid) => {
  const d = await getJSON(`/api/actor/${encodeURIComponent(aid)}`);
  $("#page").innerHTML = `<h1>Actor <code>${esc(aid)}</code></h1>` +
    "<h2>State</h2><pre>" + esc(JSON.stringify(d.actor, null, 2)) + "</pre>" +
    `<h2>Tasks (${d.tasks.length})</h2>` + renderTable("tasks", d.tasks, "");
};

PAGES.jobs = async () => {
  const jobs = await getJSON("/api/jobs");
  $("#page").innerHTML =
    `<h1>Jobs <span class="muted">(${jobs.length})</span></h1>` +
    renderTable("jobs", jobs, "") +
    '<p class="muted">submit via <code>python -m ray_tpu_torch submit -- ' +
    "&lt;cmd&gt;</code></p>";
};

PAGES.serve = async () => {
  const apps = await getJSON("/api/serve/applications/");
  const names = Object.keys(apps);
  let html = `<h1>Serve <span class="muted">(${names.length} apps)</span></h1>`;
  if (!names.length) html += '<p class="muted">serve not running</p>';
  for (const name of names) {
    const a = apps[name];
    html += `<h2>${esc(name)} <span class="status ${statusClass(a.status)}">` +
      `${esc(a.status)}</span> <code>${esc(a.route_prefix ?? "")}</code></h2>`;
    const deps = Object.entries(a.deployments).map(([d, s]) => ({
      deployment: d, status: s.status, replicas: s.num_replicas,
      message: s.message,
    }));
    html += renderTable("deployments", deps, "");
  }
  $("#page").innerHTML = html;
};

PAGES.logs = async () => {
  const prefix = tableFilters.__logprefix || "";
  const logs = await getJSON(
    `/api/logs?tail=300&prefix=${encodeURIComponent(prefix)}`);
  // Preserve the reading position across refreshes: follow the tail
  // only when pinned at the bottom, else restore the exact offset.
  const prev = $("#logpre");
  const atBottom = !prev ||
    prev.scrollTop + prev.clientHeight >= prev.scrollHeight - 4;
  const prevTop = prev ? prev.scrollTop : 0;
  $("#page").innerHTML = "<h1>Logs</h1>" +
    `<div class="toolbar"><input id="prefix" placeholder="worker prefix…" ` +
    `value="${esc(prefix)}"></div>` +
    `<pre id="logpre">` + logs.lines.map((l) =>
      esc(`[${l[0]}|${String(l[1]).slice(0, 8)}] ${l[2]}`)).join("\n") +
    "</pre>";
  const pre = $("#logpre");
  pre.scrollTop = atBottom ? pre.scrollHeight : prevTop;
  $("#prefix").addEventListener("change", (e) => {
    tableFilters.__logprefix = e.target.value;
    route();
  });
};

// ------------------------------------------------------ flamegraph page

function parseFolded(text) {
  // "a;b;c 12" lines -> trie with per-node inclusive counts.
  const root = { name: "all", value: 0, children: new Map() };
  for (const line of text.split("\n")) {
    if (!line || line.startsWith("#")) continue;
    const sp = line.lastIndexOf(" ");
    if (sp < 0) continue;
    const count = parseInt(line.slice(sp + 1), 10);
    if (!Number.isFinite(count)) continue;
    root.value += count;
    let node = root;
    for (const frame of line.slice(0, sp).split(";")) {
      let child = node.children.get(frame);
      if (!child) {
        child = { name: frame, value: 0, children: new Map() };
        node.children.set(frame, child);
      }
      child.value += count;
      node = child;
    }
  }
  return root;
}

const FLAME_COLORS = [
  "#d9734f", "#e0975a", "#c75146", "#e3b25f", "#d98a68", "#c9653b",
];
function flameColor(name) {
  let h = 0;
  for (let i = 0; i < name.length; i++) h = (h * 31 + name.charCodeAt(i)) | 0;
  return FLAME_COLORS[Math.abs(h) % FLAME_COLORS.length];
}

function renderFlame(root, focus) {
  // focus: node to zoom to (occupies full width).
  const W = Math.max(600, $("#page").clientWidth - 20);
  const ROW = 18;
  focus = focus || root;
  let maxDepth = 0;
  (function depth(n, d) {
    maxDepth = Math.max(maxDepth, d);
    for (const c of n.children.values()) depth(c, d + 1);
  })(focus, 0);
  const H = (maxDepth + 1) * ROW;
  const rects = [];
  (function walk(node, x, w, d) {
    if (w < 1) return;
    const label = w > 40
      ? `<text x="${(x + 3).toFixed(1)}" y="${(H - d * ROW - 5).toFixed(1)}">` +
        esc(node.name.length > w / 7 ? node.name.slice(0, w / 7) + "…"
            : node.name) + "</text>"
      : "";
    rects.push(
      `<g data-path="${esc(node.__path)}" data-tip="${esc(node.name)} — ` +
      `${node.value} samples (${(100 * node.value / root.value).toFixed(1)}%)">` +
      `<rect x="${x.toFixed(1)}" y="${(H - (d + 1) * ROW).toFixed(1)}" ` +
      `width="${w.toFixed(1)}" height="${ROW - 1}" ` +
      `fill="${flameColor(node.name)}"/>${label}</g>`);
    let cx = x;
    for (const c of node.children.values()) {
      const cw = (c.value / node.value) * w;
      walk(c, cx, cw, d + 1);
      cx += cw;
    }
  })(focus, 0, W, 0);
  return `<svg id="flame" width="${W}" height="${H}" ` +
    `viewBox="0 0 ${W} ${H}">${rects.join("")}</svg>`;
}

function indexPaths(root) {
  (function walk(n, path) {
    n.__path = path;
    for (const c of n.children.values()) walk(c, path + ";" + c.name);
  })(root, root.name);
}

function findPath(root, path) {
  if (path === root.name) return root;
  let node = root;
  for (const part of path.split(";").slice(1)) {
    node = node.children.get(part);
    if (!node) return root;
  }
  return node;
}

PAGES.profile = async (wid) => {
  $("#page").innerHTML = `<h1>Profile <code>${esc(wid)}</code></h1>` +
    `<div class="toolbar">duration <select id="dur">` +
    ["2", "5", "10", "30"].map((d) =>
      `<option ${d === "5" ? "selected" : ""}>${d}</option>`).join("") +
    `</select>s <button id="go">sample</button> ` +
    `<a href="/api/profile/${encodeURIComponent(wid)}">live stacks</a> ` +
    `<span id="prof-status" class="muted"></span></div>` +
    `<div id="flamebox"></div><div id="flame-tip"></div>`;
  $("#go").addEventListener("click", async () => {
    $("#prof-status").textContent = "sampling…";
    try {
      const dur = $("#dur").value;
      const r = await fetch(
        `/api/profile/${encodeURIComponent(wid)}?mode=sample&duration=${dur}`);
      if (!r.ok) throw new Error(`HTTP ${r.status}: ${await r.text()}`);
      const root = parseFolded(await r.text());
      indexPaths(root);
      if (!root.value) {
        $("#flamebox").innerHTML = '<p class="muted">no samples</p>';
        $("#prof-status").textContent = "";
        return;
      }
      const draw = (focus) => {
        $("#flamebox").innerHTML = renderFlame(root, focus) +
          '<p class="muted">click a frame to zoom; click the base to reset</p>';
        $("#flame").addEventListener("click", (e) => {
          const g = e.target.closest("g[data-path]");
          if (!g) return;
          const node = findPath(root, g.dataset.path);
          draw(node === focus ? root : node);
        });
        $("#flame").addEventListener("mousemove", (e) => {
          const g = e.target.closest("g[data-tip]");
          const tip = $("#flame-tip");
          if (!g) { tip.style.display = "none"; return; }
          tip.textContent = g.dataset.tip;
          tip.style.display = "block";
          tip.style.left = Math.min(e.clientX + 12,
            window.innerWidth - 320) + "px";
          tip.style.top = (e.clientY + 12) + "px";
        });
        $("#flame").addEventListener("mouseleave", () => {
          $("#flame-tip").style.display = "none";
        });
      };
      draw(root);
      $("#prof-status").textContent = `${root.value} samples`;
    } catch (e) {
      $("#prof-status").textContent = "";
      $("#flamebox").innerHTML =
        `<div class="err-banner">${esc(e.message || e)}</div>`;
    }
  });
};
