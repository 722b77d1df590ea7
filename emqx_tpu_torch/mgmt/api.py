"""REST API route bindings.

Parity: emqx_mgmt_api_*.erl — status, nodes, brokers, stats, metrics,
clients (list/lookup/kick/subscriptions), subscriptions, routes, publish,
mqtt subscribe/unsubscribe, banned, alarms, rules (+rule test), listeners,
apps, cluster, and the pipeline's recorder, observatory, governor and
HBM ledger. Mounted under /api/v5 (the reference 5.0-dev surface). The
port's copy of ``emqx_tpu/mgmt/api.py``.
"""

from __future__ import annotations

import base64
from typing import Optional

from emqx_tpu_torch.mgmt.httpd import ApiError, HttpServer, paginate
from emqx_tpu_torch.mgmt.mgmt import Mgmt
from emqx_tpu_torch.rules.sqlparser import parse_sql


def make_api(node, mgmt: Optional[Mgmt] = None, cluster=None,
             app_auth=None, host: str = "127.0.0.1",
             port: int = 0) -> HttpServer:
    mgmt = mgmt or Mgmt(node, cluster)
    auth_check = app_auth.is_authorized if app_auth is not None else None
    srv = HttpServer(host, port, auth_check=auth_check)
    P = "/api/v5"

    def route(method, path, handler):
        srv.route(method, P + path, handler)

    # ---- status (unauthenticated; emqx_mgmt_api_status) ----
    async def status(_req):
        return 200, {"status": "running", "node": node.name}
    srv.route("GET", "/status", status)
    route("GET", "/status", status)

    # ---- nodes / brokers ----
    async def nodes(_req):
        return await mgmt.list_nodes()
    route("GET", "/nodes", nodes)

    async def one_node(req):
        for n in await mgmt.list_nodes():
            if n["node"] == req.params["name"]:
                return n
        raise ApiError(404, "NOT_FOUND", "node not found")
    route("GET", "/nodes/:name", one_node)

    async def brokers(_req):
        return await mgmt.list_brokers()
    route("GET", "/brokers", brokers)

    # ---- stats / metrics ----
    async def stats(req):
        if req.query.get("aggregate") == "true":
            return await mgmt.stats(aggregate=True)
        return await mgmt.stats()
    route("GET", "/stats", stats)

    async def metrics(req):
        if req.query.get("aggregate") == "true":
            return await mgmt.metrics(aggregate=True)
        return await mgmt.metrics()
    route("GET", "/metrics", metrics)

    # ---- pipeline telemetry (device-path stage spans / occupancy /
    #      compile accounting — broker.telemetry snapshot schema) ----
    async def pipeline_stats(_req):
        tele = getattr(node, "pipeline_telemetry", None)
        if tele is None:
            raise ApiError(404, "SERVICE_UNAVAILABLE",
                           "pipeline telemetry not enabled")
        return tele.snapshot()
    route("GET", "/pipeline/stats", pipeline_stats)

    # ---- window-causal flight recorder: the post-mortem
    #      dump surface. Default: the overlap/bubble analysis + ring
    #      state; ?format=perfetto returns the Chrome trace-event JSON
    #      (load in https://ui.perfetto.dev or chrome://tracing) ----
    async def pipeline_trace(req):
        rec = getattr(node, "flight_recorder", None)
        if rec is None:
            raise ApiError(404, "SERVICE_UNAVAILABLE",
                           "flight recorder not enabled "
                           "(broker.trace = false?)")
        if req.query.get("format") == "perfetto":
            return rec.to_chrome()
        return {"summary": rec.analyze(),
                "ring": rec.state()}
    route("GET", "/pipeline/trace", pipeline_trace)

    # ---- device-resource observatory: the HBM ledger's
    #      `memory` section standalone — per-category live bytes /
    #      peak watermarks / pin ages + the backend memory_stats
    #      cross-check (the same document telemetry snapshot embeds) ----
    async def pipeline_memory(_req):
        ledger = getattr(node, "hbm_ledger", None)
        if ledger is None:
            raise ApiError(404, "SERVICE_UNAVAILABLE",
                           "HBM ledger not enabled "
                           "(broker.hbm_ledger = false?)")
        return ledger.section()
    route("GET", "/pipeline/memory", pipeline_memory)

    # ---- latency SLO observatory: the `latency` section
    #      standalone — per-(qos, path) ingress→routed / ingress→
    #      delivered percentiles, the SLO burn/verdict and the breach
    #      exemplars (each linked to its window's flight-recorder
    #      trace, triagable via /pipeline/trace) ----
    async def pipeline_latency(_req):
        obs = getattr(node, "latency_observatory", None)
        if obs is None:
            raise ApiError(404, "SERVICE_UNAVAILABLE",
                           "latency observatory not enabled "
                           "(broker.latency_observatory = false?)")
        return obs.section()
    route("GET", "/pipeline/latency", pipeline_latency)

    # ---- adaptive overload governor: the `overload`
    #      section standalone — current grade, armed shed actions,
    #      last signal readings and the shed counters (the graded
    #      load-shed ladder's operator surface) ----
    async def pipeline_overload(_req):
        gov = getattr(node, "overload_governor", None)
        if gov is None:
            raise ApiError(404, "SERVICE_UNAVAILABLE",
                           "overload governor not enabled "
                           "(broker.overload = false?)")
        tele = getattr(node, "pipeline_telemetry", None)
        if tele is not None:
            # the cheap standalone section — this endpoint gets polled
            # exactly while the broker is at capacity
            return tele.overload_section()
        return {"state": gov.state()}
    route("GET", "/pipeline/overload", pipeline_overload)

    # ---- clients ----
    async def clients(req):
        items = await mgmt.list_clients()
        if "username" in req.query:
            items = [c for c in items
                     if c.get("username") == req.query["username"]]
        return paginate(items, req)
    route("GET", "/clients", clients)

    async def client(req):
        c = await mgmt.lookup_client(req.params["clientid"])
        if c is None:
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        return c
    route("GET", "/clients/:clientid", client)

    async def kick(req):
        if not await mgmt.kick_client(req.params["clientid"]):
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        return 204, b""
    route("DELETE", "/clients/:clientid", kick)

    async def client_subs(req):
        return await mgmt.client_subscriptions(req.params["clientid"])
    route("GET", "/clients/:clientid/subscriptions", client_subs)

    # ---- subscriptions / routes ----
    async def subscriptions(req):
        items = await mgmt.list_subscriptions()
        if "clientid" in req.query:
            items = [s for s in items
                     if s.get("clientid") == req.query["clientid"]]
        return paginate(items, req)
    route("GET", "/subscriptions", subscriptions)

    async def routes(req):
        return paginate(mgmt.list_routes(), req)
    route("GET", "/routes", routes)
    route("GET", "/topics", routes)

    async def one_route(req):
        r = mgmt.lookup_route(req.params["topic"])
        if r is None:
            raise ApiError(404, "TOPIC_NOT_FOUND")
        return r
    route("GET", "/routes/:topic", one_route)
    route("GET", "/topics/:topic", one_route)

    # ---- publish / subscribe (emqx_mgmt_api_publish / _pubsub) ----
    def _decode_payload(body: dict) -> bytes:
        p = body.get("payload", "")
        if body.get("encoding") == "base64":
            return base64.b64decode(p)
        return p.encode() if isinstance(p, str) else bytes(p)

    async def publish(req):
        body = req.json() or {}
        if "topic" not in body:
            raise ApiError(400, "BAD_REQUEST", "topic required")
        n = await mgmt.publish(body["topic"], _decode_payload(body),
                               qos=int(body.get("qos", 0)),
                               retain=bool(body.get("retain", False)),
                               clientid=body.get("clientid", "http_api"),
                               properties=body.get("properties"))
        return {"deliveries": n}
    route("POST", "/publish", publish)
    route("POST", "/mqtt/publish", publish)

    async def publish_batch(req):
        out = []
        for body in req.json() or []:
            n = await mgmt.publish(
                body["topic"], _decode_payload(body),
                qos=int(body.get("qos", 0)),
                retain=bool(body.get("retain", False)),
                clientid=body.get("clientid", "http_api"),
                properties=body.get("properties"))
            out.append({"topic": body["topic"], "deliveries": n})
        return out
    route("POST", "/mqtt/publish_batch", publish_batch)

    async def mqtt_subscribe(req):
        body = req.json() or {}
        rc = await mgmt.subscribe_client(body.get("clientid", ""),
                                         body.get("topic", ""),
                                         int(body.get("qos", 0)))
        if rc is None:
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        if rc > 2:
            raise ApiError(400, "SUBSCRIBE_FAILED",
                           f"reason code 0x{rc:02x}")
        return {"ok": True, "qos": rc}
    route("POST", "/mqtt/subscribe", mqtt_subscribe)

    async def mqtt_unsubscribe(req):
        body = req.json() or {}
        ok = mgmt.unsubscribe_client(body.get("clientid", ""),
                                     body.get("topic", ""))
        if not ok:
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        return {"ok": True}
    route("POST", "/mqtt/unsubscribe", mqtt_unsubscribe)

    # ---- banned (emqx_mgmt_api_banned) ----
    async def banned_list(req):
        return paginate([{
            "as": b.kind, "who": b.value, "by": b.by, "reason": b.reason,
            "at": int(b.at), "until": int(b.until) if b.until else None}
            for b in node.banned.all()], req)
    route("GET", "/banned", banned_list)

    async def banned_create(req):
        body = req.json() or {}
        if body.get("as") not in ("clientid", "username", "peerhost"):
            raise ApiError(400, "BAD_REQUEST", "as must be clientid/"
                                               "username/peerhost")
        node.banned.create(body["as"], body["who"],
                           by=body.get("by", "mgmt_api"),
                           reason=body.get("reason", ""),
                           duration=body.get("seconds"))
        return 201, body
    route("POST", "/banned", banned_create)

    async def banned_delete(req):
        if not node.banned.delete(req.params["as"], req.params["who"]):
            raise ApiError(404, "NOT_FOUND")
        return 204, b""
    route("DELETE", "/banned/:as/:who", banned_delete)

    # ---- alarms ----
    async def alarms(req):
        which = req.query.get("activated")
        which = {"true": "activated", "false": "deactivated"}.get(
            which, "all")
        return node.alarms.get_alarms(which)
    route("GET", "/alarms", alarms)

    async def alarms_clear(_req):
        return {"cleared": node.alarms.delete_all_deactivated()}
    route("DELETE", "/alarms/deactivated", alarms_clear)

    # ---- rules (emqx_rule_engine_api) ----
    def _engine():
        eng = getattr(node, "rule_engine", None)
        if eng is None:
            raise ApiError(404, "SERVICE_UNAVAILABLE",
                           "rule engine not loaded")
        return eng

    async def rules_list(_req):
        return [r.to_map() for r in _engine().list_rules()]
    route("GET", "/rules", rules_list)

    async def rules_create(req):
        body = req.json() or {}
        try:
            rule = _engine().create_rule(
                body["sql"], body.get("actions", []),
                rule_id=body.get("id"),
                enabled=body.get("enabled", True),
                description=body.get("description", ""))
        except Exception as e:  # noqa: BLE001 — SQL errors are 400s
            raise ApiError(400, "BAD_SQL", str(e))
        return 201, rule.to_map()
    route("POST", "/rules", rules_create)

    async def rule_get(req):
        r = _engine().get_rule(req.params["id"])
        if r is None:
            raise ApiError(404, "RULE_NOT_FOUND")
        return r.to_map()
    route("GET", "/rules/:id", rule_get)

    async def rule_update(req):
        eng = _engine()
        r = eng.get_rule(req.params["id"])
        if r is None:
            raise ApiError(404, "RULE_NOT_FOUND")
        body = req.json() or {}
        if "sql" in body or "actions" in body or "description" in body:
            # validate EVERYTHING before touching the existing rule so a
            # bad update can never destroy a working rule
            try:
                parse_sql(body.get("sql", r.sql))
            except Exception as e:  # noqa: BLE001
                raise ApiError(400, "BAD_SQL", str(e))
            actions = body.get("actions", r.actions)
            if not (isinstance(actions, list) and
                    all(isinstance(a, dict) and "name" in a
                        for a in actions)):
                raise ApiError(400, "BAD_REQUEST",
                               "actions must be a list of {name, params}")
            enabled = r.enabled
            eng.delete_rule(r.id)
            r = eng.create_rule(body.get("sql", r.sql), actions,
                                rule_id=req.params["id"], enabled=enabled,
                                description=body.get("description",
                                                     r.description))
        if "enabled" in body:   # applied last: validation already passed
            eng.enable_rule(r.id, bool(body["enabled"]))
        return r.to_map()
    route("PUT", "/rules/:id", rule_update)

    async def rule_delete(req):
        if not _engine().delete_rule(req.params["id"]):
            raise ApiError(404, "RULE_NOT_FOUND")
        return 204, b""
    route("DELETE", "/rules/:id", rule_delete)

    async def rule_test(req):
        body = req.json() or {}
        try:
            out = _engine().test_sql(body["sql"], body.get("context", {}))
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, "BAD_SQL", str(e))
        return {"outputs": out}
    route("POST", "/rule_test", rule_test)

    # ---- listeners ----
    async def listeners(_req):
        return [{"node": node.name, "protocol": getattr(l, "protocol",
                                                        "mqtt:tcp"),
                 "bind": f"{getattr(l, 'bind', '0.0.0.0')}:"
                         f"{getattr(l, 'port', 0)}",
                 "current_conns": getattr(l, "current_conns", 0)}
                for l in node.listeners]
    route("GET", "/listeners", listeners)

    # ---- apps (api credentials; emqx_mgmt_api_apps) ----
    if app_auth is not None:
        async def apps_list(_req):
            return app_auth.list_apps()
        route("GET", "/apps", apps_list)

        async def apps_create(req):
            body = req.json() or {}
            try:
                secret = app_auth.add_app(body["app_id"],
                                          body.get("name", body["app_id"]),
                                          body.get("secret"),
                                          body.get("desc", ""))
            except ValueError:
                raise ApiError(409, "ALREADY_EXISTS")
            return 201, {"app_id": body["app_id"], "secret": secret}
        route("POST", "/apps", apps_create)

        async def apps_delete(req):
            if not app_auth.del_app(req.params["app_id"]):
                raise ApiError(404, "NOT_FOUND")
            return 204, b""
        route("DELETE", "/apps/:app_id", apps_delete)

    # ---- cluster ----
    async def cluster_info(_req):
        if cluster is None:
            return {"nodes": [node.name], "self": node.name}
        return cluster.info()
    route("GET", "/cluster", cluster_info)

    return srv
