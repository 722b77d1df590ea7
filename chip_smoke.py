#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (emqx_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (nvcc); without a card it
exits 1 before doing anything. Every check raises on failure, so any
failed phase ends the run with a non-zero exit code.

Phases:
1. versions, and the card's name and power limit (nvidia-smi);
2. build the three kernels from emqx_tpu_torch/csrc (one nvcc each, in
   parallel);
3. each kernel against its plain PyTorch version on the card, exact
   integer equality: prefix_sum against torch.cumsum at every row kind
   and at the main paths' shapes, on unaligned views, past int32
   wraparound, over 2000 calls back to back, across state-buffer growth
   and on two streams at once; shape_match (fold planes and matches) on a
   ~100k-filter six-pattern population and on the 10M-subscription bench
   population;
4. the main path at full size: 10M subscriptions on device/{id}/+/{num}/#,
   50% of filters in 16-filter, 8-member $share groups under round robin,
   B=131072, W=8, fanout_cap=4, slot_cap=2. RouteEngine.route() routes one
   window of topic strings with the launch counters set to 0 just before
   and read just after; the window's planes and cursors are held against
   the plain path on the card; every message is checked against the
   population's known answer (fid = id*nums + num, one normal
   subscriber); round robin must be fair within a window. Then timed
   windows (encoded topics staged on the card) give matches/s and the
   window latency, torch.profiler splits one window's device time (and
   must show one prefix_sum kernel entry per wrapper call), and each
   kernel is timed at the main path's shapes beside its bound, its plain
   version and a library call; prefix_sum at every shape the route()
   window launched it with, beside its launches per window, an empty
   kernel at the same grid (the launch floor), torch.cumsum and the
   wrapper call;
5. the kernels JSON line, the card line, and the result line last
   (after phases 6 to 20, with kernel 2 timed at the shapes phases 9-20
   added, in a process of its own); every phase prints its start and
   deadline as it starts and its wall seconds as it ends ("phase N: S s
   wall"), and the whole run's line lists them;
6. kernel 3, ring_rotate, against its plain version on the card, exact:
   every hop count at the mesh phase's [E, 3] block and at a ragged
   [1001, 3] block (aligned and unaligned), and across two cards with
   peer writes where the machine has them;
7. the mesh path at full size: 1,000,000 filters device/{id}/+/{num}/#,
   one subscriber each (session = population fid), Zipf-skewed
   publishes, dp=2 x route=4 as 8 trie shards on one card, B=131072,
   the reference server's caps. One warm-up window sizes the exchange
   segments (E); then ShardedRouteEngine.route() routes one window of
   topic strings with the launch counters set to 0 just before and read
   just after, and every plan is checked against the known answer; the
   step's planes and the ExchangeResult are held against the plain path
   on the card, and every session's delivery order against the host
   gather of the same window; timed windows (all served by the
   exchange) give the window latency and matches/s; torch.profiler
   splits one window; ring_rotate is timed at its main-path shape
   beside its bound, its plain version and torch.roll, and prefix_sum at
   every shape of the mesh's route() window, as in phase 4. Covering is
   on (the reference's default): every shard carries cover tables (an
   identity CSR here, nothing is covered) and the step expands each
   shard's rows; the cover totals and the detection seconds are printed,
   and 50 windows with covering off and 50 with it on again give both
   p50/p99 in the same call;
8. the broker's serving path over live TCP at bench.py's e2e size
   (run_e2e(100_000, 16, 8, 32_000 // 8), bench.py:1981-2002): the port's
   Node with its Listener on 127.0.0.1, 99,856 filters
   device/d{i}/+/n{n}/# subscribed in SUBSCRIBE packets of 512 over 16
   connections (half in 2-member $share/bg groups on different
   connections, round robin; the rest plain at QoS 0), the bench's
   warm-up, then 16,000 PUBLISHes (cut from 32,000 for time) from 8
   connections (every 4th at QoS 1
   with pipelined PUBACKs) at dispatch_depth 2 and again at 1 on the same
   node with the delivery lanes on (the default, min(4, cpus) lanes), and
   once more at depth 2 with the node's lane pool detached (inline
   delivery, what deliver_lanes 0 builds), the launch counters set to 0
   around each flood. Each flood must deliver every message exactly once
   to a connection holding its filter, in publish order per publisher at
   every subscriber (per delivery class, see _flood), grow
   routing.device.batches, launch shape_match and prefix_sum, and route
   at least 90% of its messages through the device engine; a lanes flood
   must hand rows and plans to the lanes (pipeline.deliver.rows/plans),
   the inline one none. Each flood prints its msgs/s, latency, host us
   per message by stage (consume is the plan construction with the
   lanes), the lanes' own delivery time and the pinned host blocks
   allocated during it; the first prints the telemetry snapshot's
   stages, decisions and graph captures over it. After the floods the
   HBM ledger's line: live bytes by category, the peak, the static
   buffers of each graph class, and the accounted share of
   torch.cuda.memory_allocated, which must not exceed 1 (aliases
   counted twice). The node runs at the reference's defaults (dedup,
   match cache 8192, delta overlay, telemetry, ledger, lanes). Two
   engine windows of
   flood topics are held against the plain path, every plane and the
   cursors: a uniform one (the plain window) and one drawn from 512
   topics (the dedup-cached window). Covering is on (no filter of this
   population covers another: no cover state; the detection seconds are
   printed);
9. the reference's default routing layers at phase 8's population, built
   in-process through broker.subscribe: node A at the defaults, node B
   with dedup, cache and overlay off, and a host-path node. 9a, the skew
   traffic of tools/skew_bench.py:82-105 (90% of the lanes on 16 hot
   topics): a warm-up until every class it wants is captured, then
   passes of 8 fused windows of 8 x 1024 (48 before phase 18 took the
   time, 24 before phase 20, 16 before QUIC) through prepare_window →
   dispatch → materialize → finish_sub with two windows in flight, A and
   B alternating by pass; every pass's deliveries, shared picks and
   device cursors must be equal on A and B and the host path's counts
   and deliveries equal A's; in the timed pass at least 90% of A's
   windows must be cached windows, its cache must hit and no cached class
   may be cold. 9b, the churn traffic of tools/churn_bench.py:80-160: a
   sink session subscribes 4 fresh filters churn/{seq}/+ between
   batches (64 live at most), 8 route_batch of 512 a pass (48 before
   phase 18) with 25% of the lanes to
   the fresh filters' topics; per batch A, B and the host path must give
   equal counts and per-session deliveries, every fresh-filter lane
   delivered; in the timed pass A routes no delta filter on the host and
   applies the overlay. Then a cached and an overlay window on A are held
   against the plain path, and kernel 2 is timed at every shape phase 9
   adds (in a fresh process: ``--scan-shapes``). Node A has covering on,
   B off;
10. subscription covering, as tools/cover_bench.py:53-175 drives it: nodes
   A (covering on) and B (off), dedup off, fan-out cap 4, slot cap 2, one
   session subscribed to every filter of cover_heavy_filters(n, 0.6) for
   n = 10,000 (the bench's default) and 100,000 (phase 8's scale); 16
   batches of 1,024 topics drawn uniformly from concretize(filter) go
   through prepare → dispatch → materialize (a warm pass, then one timed
   pass, A's launch counters set to 0 around them):
   topic-matches/s and window p50/p99 of A and B, the backend each
   built, the cover state, detection and build seconds, graph classes,
   capture seconds and the capture's peak device memory. Every covered
   window is then held against the plain path bit for bit; A, B and the
   host path must deliver identically on a route_batch of 1,024; one
   covered SUBSCRIBE must land on A as an append (no overlay row), and
   the next window (a graph replay where A is on the shape tables) must
   deliver it as B does;
11. columnar PUBLISH ingress, as tools/ingress_bench.py:52-215 drives it:
   64 and 256 connections, each writing 200 pre-serialized QoS 0
   PUBLISHes of 64 bytes over 16 topics at once, one subscriber holding 1
   of them, each (connections, columnar on / off) in a process of its own
   (``--ingress``, the four started together, each run alone) after a
   warm pass, the chooser held on the device:
   msgs/s, the stage decomposition, the ``ingress`` section, the device
   share and kernel 2's launches by shape. Each run must deliver the
   known count (13 a publisher) in publisher order with at least 0.9 on
   the device, and hold one window of its flood's topics against the
   plain path; the columnar run must take the burst path (bursts > 0) on
   the host native library (not its Python mirrors), and the per-packet
   run must have no ``ingress`` section;
12. the overload governor, as tools/overload_bench.py:1-60 drives it:
   twin nodes, the governor on and off, each in a process of its own
   (``--overload``, started while phase 11 runs), the chooser held on
   the device: 16 connections
   writing pre-serialized QoS 0 PUBLISHes with every 16th row at QoS 1,
   8 topics, 64-byte payloads, the governor polled every 0.05 s (the
   bench's ladder tuning), a 500 ms objective. A warm pass measures the
   governed node's sustained msgs/s; both twins' floods are paced at
   twice that, 7,000 PUBLISHes a connection cut to fit 20 s. Both must
   deliver every accepted QoS 1 PUBLISH in publisher order, launch
   shape_match and prefix_sum and route at least 0.9 of their messages,
   and of their windows of at least device_min_batch rows, on the
   device; only the governed twin may shed (QoS 0 only), and it must
   shed and come back to normal with nothing armed after the drain.
   After the drain each twin holds two windows of the flood's own topic
   sequence against the plain path: a fused one (the dedup plan) and a
   QoS 1-only one, what a window is while QoS 0 is shed; kernel 2's
   launch shapes over the flood are recorded, and those no earlier phase
   timed are timed. The grade timeline and both routed p99s beside the
   objective are printed, not asserted;
13. fault-domain supervision on the card (emqx_tpu_torch/chaos.py, the
   port's copy of tools/chaos_bench.py). 13a: the 24 cells (every
   pipeline injection point x every fault kind) at the bench's size on a
   cuda node with the bench's tuning (threshold 1, cooldown 0.05 s,
   watchdog floor 0.1 s, multiplier 0), each graded against the card's
   fault-free twin (equal counts and per-session order, nothing dropped,
   a trip within the faulted window, stalls for hangs at dispatch and
   materialize, replays for raising kinds there, rung 0 again, the
   journal and the HBM ledger's pins at 0) and held equal to the same
   cell on the port's CPU node (run meanwhile in four processes of their
   own). 13b runs inside phase 8, on its node: one
   more flood at depth 1 with a readback hang and three dispatch faults
   armed mid-flood at the node's threshold (3); every message delivered
   once and in order, the hang a stall, every faulted window replayed,
   the trip, the seconds back to rung 0, the replayed windows' host us a
   message, and the first window after recovery held against the plain
   path. 13c: the half-open dispatch probes' kernel launches (shape_match
   and prefix_sum, over 13a and 13b) must be above 0. 13d: on the card, a
   non-injected RuntimeError raised inside one dispatch reaches the
   publishers and sets engine.failed, while an InjectedFault raised in
   the same place replays; a real out of memory in the dispatch and a
   real readback stall past the watchdog (no clause armed) fail as the
   RuntimeError does.
14. the mesh serving under Node (``broker.multichip``: the port's
   ShardedRouteServer, dp=2 x route=4 shards on the card). 14a:
   tools/sharded_bench.py's drive at a quarter of its size
   (SHARDED_r05.json's 99,856): 24,964 filters dev/d{i}/+/n{n}/#,
   max_batch 128, the exchange class warmed
   on flood-shaped traffic, 40 oracle-checked batches through the
   pipelined dispatch (one delivery each message), a window held
   against the plain path (the step, the exchange and the CSR
   compaction, exact), 2 x 32 subscribes served as single-shard updates,
   and a shared-slot burst that outgrows its class: windows route on the
   host (counted) while the background full build runs, none lost. 14b:
   a quarter of phase 8's population and 8,000 PUBLISHes over TCP
   through a
   multichip node at the reference's max_batch 256 (the chooser held on
   the mesh): every message once, in publisher order per topic at every
   session (the mesh delivers a window by source shard, as the
   reference does), msgs/s, latency, the device share, exchange windows
   against gathers by reason, the exchange telemetry section, the
   ledger's mesh categories and its share of memory_allocated;
   prefix_sum and ring_rotate must be launched. 14c: a mesh_exchange
   fault armed mid-flood on the same node trips the breaker, replays on
   the host and returns to rung 0 (seconds printed), and a real failure
   in a small mesh node's step raises and fails the server. Then the
   single-chip engine's incremental capture at a quarter of phase 8's
   population (three pairs):
   the capture seconds of the full build against the incremental one
   after 512 churned filters, the two captures equal, the next window
   exact against the plain path.
15. the default node booted from the repo's etc/emqx.conf, as the
   reference's README boots it: the file copied unchanged to a temp dir
   with a runtime-override file beside it (the shipped tcp and ws
   listeners moved to 127.0.0.1 port 0, the commented ssl_default and
   quic_default listeners added with certificates made by
   utils.tls.generate_self_signed, the congestion alarm on with a 1 s
   sustain, a 5 s latency objective), Config.load_file, then
   Node.from_config_file on the card, start_listeners and
   start_timers. 15a: phase 8's population
   subscribed over TCP, 2 of the 16 connections over QUIC, the warm-up,
   then 16,000 PUBLISHes from 4 TCP, 2 TLS, 2 WebSocket and 2 QUIC
   publishers (every 4th at QoS 1): every message
   once and in order (as phase 8), at least 0.9 on the device, kernels 1
   and 2 launched (one shape_match a window); msgs/s overall and by
   transport (delivered: a transport's messages over the time to their
   last delivery), client p50 / p99, the columnar burst share by
   transport and the launches a window by shape; per QUIC connection,
   client and listener side, over the flood: cwnd, ssthresh, halvings,
   retransmits, datagrams sent, received and dropped by the socket, and
   the bytes left blocked. 15b on that node: a
   banned clientid refused with CONNACK 0x8A over each transport and
   admitted once its ban expired and sweep ran; OsMon's readings and the
   alarms it raised (printed, not failed on); a subscriber that stops
   reading during a 5,000-message QoS 0 burst of 8 KB raises
   conn_congestion/<clientid>/<user> and connection.congested, and the
   alarm clears once it reads again. 15c: 4,000 PUBLISHes through that
   node (CSR readback) and through a compact_readback: false node booted
   from the same files: every plain subscription's deliveries equal per
   session, no compact window and no cold compact class on the dense
   node; readback bytes a message and windows by mode, msgs/s and kernel
   2's launches a window by shape both ways; then a multichip node with
   compact_readback false and its CSR twin, a quarter of phase 8's
   population in process, 2,000 messages in the same windows through
   both: every session's deliveries equal. 15d: a device_route: false
   node with a quarter of the population and 8,000 PUBLISHes: every
   message once and in order, no kernel launched,
   torch.cuda.memory_allocated unchanged by the node; its msgs/s is the
   host baseline. 15e on the booted node's quic listener: the TLS
   engine's refusals (an untrusted CA, a hostname mismatch, no common
   ALPN), each leaving no connection; a Retry round trip; 20 QoS 1
   PUBLISHes through a connection that drops every 3rd datagram both
   ways, delivered once and in order; a silent client's connection
   reaped once idle; then stop_listeners must close the UDP socket,
   every QUIC connection and every MQTT task it had.
16. the feature apps and the management API, as the reference's README
   boots them: phase 15's files plus, in the override, the dashboard on
   127.0.0.1 port 0, one rewrite rule (rw/src/# to rw/dst/$1, no flood
   topic matches it), topic metrics on device/d0/+/n0/# and
   device/+/x/n0/#, and flapping detection (5 disconnects in 10 s ban for
   2 s); Node.from_config_file on the card, start_listeners, start_apps
   (the shipped retainer and delayed publish, rewrite, topic metrics,
   flapping), start_dashboard and start_timers(1.0). 16a: a quarter of
   phase 8's population over 16 TCP connections, the warm-up, 8,000
   PUBLISHes
   from 8 TCP publishers (every 4th QoS 1, every 8th retained), the
   message.publish hook fold live in every window: every message once
   and in order, at least 0.9 on the device, kernels 1 and 2 launched,
   the retained count equal to the distinct retained topics sent and
   each topic-metrics filter's in and out counts equal to the messages
   sent to it; msgs/s, client p50 / p99, the burst share, the fold's
   batch_form stage p50 / p99 beside 15a's, and the launches a window by
   shape. 16b (bench.py's run_config5 replay, half CONFIG5_10M.json's
   100,000 retained): one TCP publisher sends 50,000 retained QoS 0
   PUBLISHes c5r/{i % 64}/k{i} through the node (a QoS 1 PUBLISH acked
   every 4,096 paces it); a c5r/0/+ subscriber replays exactly 782, a
   retain-handling-2 one none and a late c5r/# one all 50,000, each
   with the retain flag; publish and replay msgs/s, and a sweep's
   seconds with them stored and after they are cleaned. 16c, run
   between 16b's stream and its replays: the governor's readings
   scripted into overload park a c5r/2/# subscriber's replay
   (defer_retained, counted once); back to normal, the sweep that
   unwinds defer_retained replays its 782 (and leaves the governor
   at normal for 16b's replays). 16d: login, the five
   /api/v5/pipeline endpoints (trace with windows, perfetto JSON, the
   ledger's share of the card's allocated bytes at most 1), a REST
   publish, the rewrite, a $delayed/2 PUBLISH arriving 2 to 3 s later,
   /api/v5/routes against the population, SysBroker's $SYS pipeline
   payloads one per snapshot section, the CLI (status, trace device
   start/stop) and a flapping client refused 0x8A then admitted once its
   ban expired and sweep ran.
17. the cluster (emqx_tpu_torch/cluster, bench.py:1003-1163's config 5
   and tools/chaos_cluster.py). 17a: two nodes of one process on the
   card joined over loopback rpc with 1 s heartbeats, a quarter of
   phase 8's population (24,964 filters, cut for time) over TCP with
   subscriber connection c on node c % 2 (every shared group has a
   member on each node): the route sync (entries taken from the peer a
   second, wall seconds) and 100 single adds' p50 / p99 until visible
   on the peer; each node's snapshot must hold every filter and one
   remote member per group; 8,000 PUBLISHes
   (cut from 32,000 for time) from 4 TCP publishers on each node, every
   4th QoS 1: every message once across the cluster (a shared one to one
   member of its group), in order per publisher and topic; msgs/s,
   client p50 / p99, and per node the device share, forwards sent and
   received, messages.routed.device.remote_shared (> 0) and kernel 1 and
   2 launches a window (> 0). 17b: emqx_tpu_torch/chaos_cluster.py over
   three ``python -m emqx_tpu_torch.run_node`` processes on the card
   (started one after another while 17a runs), one kill cycle under a QoS 1 flood (invariants 1-6, bounds x2): each
   cycle's re-homed CONNECT seconds, PUBACK gap and seconds to 3 running
   nodes. 17c: a node with 17a's population as persistent sessions and
   half of 16b's retained messages (25,000): save_snapshot (seconds,
   bytes),
   1,000 route adds and retained sets in the write-ahead log, a fresh
   node's load_snapshot (seconds, the router's device tables), its
   sessions back, its engine snapshot built; a 2,000-message flood must
   deliver what the original node delivered (its first window launching
   kernel 1) and a late c5r/# subscriber must replay all 26,000. 17d: a
   multichip node and a single-chip node joined in process, 17a's
   population split over them, 2,000 messages through the mesh node:
   every message once, order per topic, remote picks forwarded; the
   exchange serves no clustered window (the reference precludes it), so
   kernel 3 is read in the class warm under the cluster and in windows
   after the node leaves it.
18. the secured node: phase 15's files plus, in the override, the
   dashboard on 127.0.0.1 port 0, the authn chain (built_in_database by
   username with sha256 and a prefix salt, JWT HS256, SCRAM sha256), the
   file ACL (subscribe device/# and rules/#; publish device/# but not
   device/+/forbidden/#; no_match deny; the cache on) and two rules
   (r_q1: SELECT clientid, topic, qos FROM "device/#" WHERE qos = 1,
   republished to rules/q1/${clientid} at QoS 1; r_conn: the
   client_connected event, republished to rules/conn/${clientid});
   Node.from_config_file on the card, start_listeners, start_apps,
   start_dashboard, start_timers(1.0). 18a: a rules/# subscriber first,
   8 v5 publishers (2 by JWT), one client by the SCRAM AUTH exchange and
   its re-authentication, a quarter of phase 8's population subscribed
   by 16 logged-in connections, the warm-up, then 8,000 PUBLISHes (cut
   from 32,000 for time) with 100 denied QoS 1 PUBLISHes to device/d{i}/forbidden/...
   mixed in: every allowed message once and in order, at least 0.9 on
   the device, kernels 1 and 2 launched (one shape_match a window), two
   engine windows held against the plain path; r_q1 must read
   sql.matched 8,000, sql.passed and actions.success 2,000, rules/#
   must receive exactly the 2,000 republishes and one rules/conn/<id> for
   each CONNECT after it subscribed, and the republishes must be routed
   once each on the host; msgs/s, client p50 / p99, the fold's
   batch_form beside 15a's and 16a's, the authn and authz counters and
   the cache's hits. 18b: a wrong password refused 0x86 (v5) and 4
   (v3.1.1), a JWT with a bad signature and a SCRAM CONNECT with a wrong
   password 0x87, a SUBSCRIBE outside the ACL 0x87 and not in the
   router, every denied PUBLISH answered PUBACK 0x87, none routed or
   delivered; the SCRAM CONNECT's seconds. 18c: /api/v5/rules over the
   dashboard listener: create, list, get, update, a refused update,
   rule_test, delete; the rule made there fires on the next window of 64
   QoS 1 PUBLISHes.
19. the database-backed node: phase 15's files plus, in the override,
   the authn chain MySQL (caching_sha2), PostgreSQL (SCRAM), LDAP (a
   service bind, a search, the user's bind), the authz sources Redis
   (HGETALL mqtt_acl:%u) then PostgreSQL (no_match deny, the cache on)
   and r_up (SELECT * FROM "device/#" WHERE qos = 1 -> data_to_up); the
   servers are tests/test_torch_fake_db.py's in this process, every user
   stored as a salted sha256 hash. start_apps creates their resources on
   node.resources; the script adds up, an mqtt resource on a second,
   host-only node of the port. 19a: 8 publishers log in by PostgreSQL,
   a quarter of phase 8's population subscribes through 16 MySQL logins
   (superusers: authz skips their filters), the warm-up, then 8,000
   PUBLISHes with
   100 denied QoS 1 PUBLISHes mixed in (no ACL row allows them): every
   allowed message once and in order, at least 0.9 on the device,
   kernels 1 and 2 launched, two engine windows held against the plain
   path, every denied PUBLISH answered 0x87, and the remote must receive
   each of the 2,000 QoS 1 messages once through data_to_up. 19b: an
   MqttBridgeWorker forwards bridge/# under edge/ to the remote and takes
   its cmd/# in under from-cloud/: 1,000 QoS 1 PUBLISHes forwarded, the
   remote's listener stopped, 500 more held in the bridge's disk queue,
   the listener restarted on the same port, all 1,500 at the remote once
   and in publish order; 50 remote cmd/# messages reach a local
   subscriber under the mountpoint. 19c: an LDAP login accepted and a
   wrong LDAP password refused (0x86), a wrong MySQL password refused
   (0x86); stop_listeners leaves no resource and every server sees every
   connection closed. The servers' query counts must equal the known
   answers: one authn query a CONNECT in chain order, one Redis query an
   authz cache miss, one PostgreSQL ACL query a denied topic.
20. Extension, export and the protocol gateways: etc/emqx.conf booted
   under phase 15's override plus the dashboard and gateway blocks for
   stomp (TCP), mqttsn, coap and lwm2m (UDP) on port 0, with an exhook
   server and an exproto block where grpc imports (it does on the card);
   prometheus.register_api on the dashboard server, a StatsD
   app and a telemetry reporter aimed at receivers in this process, one
   plugin loaded from a module file. 20a: 8 STOMP subscribers, 4 MQTT-SN
   (QoS 0) and 2 CoAP observers, each on device/d{j}/x/# for its own j,
   beside a quarter of phase 8's population; 8,000 PUBLISHes from 8
   publishers: every
   MQTT delivery once and in order, at least 0.9 of the messages on the
   device, kernels 1 and 2 launched, two engine windows held against the
   plain path, each gateway client's count equal to its known answer and
   each STOMP connection in publish order per publisher and delivery
   class. 20b: 1,000 STOMP SENDs, 1,000 MQTT-SN QoS 1 PUBLISHes (each
   PUBACKed) and 200 CoAP POSTs reach one MQTT subscriber once each,
   routed as the reference routes gateway ingress (publish_async).
   20c: an LwM2M endpoint (registered before the population) gets 100
   read commands an MQTT client sends to lwm2m/ep-20/dn/cmd (the chooser
   held on the device), answers each, and all 100 replies reach an MQTT
   subscriber of up/#; it deregisters and no session is left. 20d: three
   /metrics scrapes during 20a (each histogram's _count equal to its +Inf
   bucket), emqx_messages_publish equal to the node's counter after it,
   the StatsD counter deltas summing to the counter's rise over the
   flood, one telemetry report with the node's version, the plugin in
   ``plugins list`` and its unload run. 20e: with grpc, the exhook
   provider (message.publish on device/d{j}/# for 8 ids, answered
   CONTINUE in the batcher's fold) gets one OnMessagePublish for each of
   the flood's PUBLISHes to those topics; without, it prints that it did
   not run. stop_listeners closes every
   gateway socket and leaves the registry empty.

Every node of phases 8-12 runs supervised, as the default node does, and
must end its phase with no supervised fault, replay, stall or trip (the
supervisor hides no device fault on the paths that pass). Phase 8 adds
its depth-2 lanes flood with the supervisor detached (what ``supervise:
false`` builds) in two rounds against the supervised one (three before
phase 18 took the time), the order
rotated, and prints both msgs/s by median and the live ``supervise``
telemetry section, and times each supervision hook on the live
supervisor (host us a fault-free window, against the flood's wall time a
window).

Phase 8's node runs with columnar ingress on (the default); each flood
prints its ingress counters (bursts, rows, per-packet frames), the share
of its PUBLISHes that came in bursts, the rows per burst and the prepare
stage's us per message. It runs the flight recorder, the latency
observatory and the overload governor too, at the reference's defaults
(the governor built but not polled, as bench.py's run_e2e leaves it):
each flood prints the recorder's spans, windows and drops, the analyzer's
dispatch<->materialize overlap and bubbles by class over the windows the
ring still holds (each device window among them must have its enqueue,
dispatch, materialize and deliver spans), and the observatory's
ingress->routed and ingress->delivered p50 / p99 by (QoS, path) and the
SLO burn (its routed samples must equal the flood's PUBLISHes by QoS).
One more depth-2 flood runs with both detached (msgs/s on and off,
no ratio claimed). The profiled flood runs under the engine's device
trace with a recorder whose ring holds the whole flood (nothing may be
overwritten): every ``route_step#<trace id>`` range must name a trace
the ring holds a dispatch span under.

Every phase runs under a deadline: as it starts, the run prints
"phase N: start at T s, deadline in D s" and re-arms
``faulthandler.dump_traceback_later(D, exit=True)``, D = min(2 x the
phase's ceiling in PHASE_CEILING_S, RUN_DEADLINE_S (950 s) less the
seconds gone). A phase that stalls past it ends the run with exit code
1: every thread's stack on stderr, the main thread's last, its outer
frames naming the phase's function, and no result line. The ceilings
add up to at most 700 s on one H100 (PERF.md §5).

``python3 chip_smoke.py --boot`` builds the kernels and runs phase 15
alone; ``python3 chip_smoke.py --apps`` phase 16;
``python3 chip_smoke.py --cluster`` phase 17;
``python3 chip_smoke.py --secure`` phase 18;
``python3 chip_smoke.py --db`` phase 19;
``python3 chip_smoke.py --ext`` phase 20; each arms its phase's
deadline once the kernels are built.
``python3 chip_smoke.py --warm-stress`` runs 16a, then 16b's stream
beside a loop of the engine's class warms: the reproducer of a fixed
fault (a graph capture on a stream serving used, after which every
``pin_memory`` raised ``CUDA error: invalid argument``); it exits 1
where the fault shows.

``python3 chip_smoke.py --trace-cost`` runs phase 8's node alone with
its depth-2 lanes flood in eight rounds of four layer settings (the
recorder and the observatory on, off, the observatory alone, both on
with an objective no message breaches), each round's order rotated,
and prints each setting's msgs/s and readback us a message over the
rounds.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import re
import subprocess
import sys
import time
import zlib

import numpy as np

SUBS = 10_000_000
BATCH = 131_072
WINDOW = 8
FANOUT_CAP = 4
SLOT_CAP = 2
SHARED_PCT = 50
PAYLOAD_CAP = 1 << 20      # fits the bench window's ~6 entries per message
TIMED_WINDOWS = 100
PATTERN_FILTERS = 100_000
SEED = 7

MESH_SUBS = 1_000_000
MESH_BATCH = 131_072
MESH_DEVICES, MESH_DP = 8, 2
MESH_CAPS = dict(frontier_cap=16, match_cap=64, fanout_cap=128,
                 slot_cap=16)          # the reference server's defaults
LEVEL_CAP = 16
MESH_TIMED = 50               # 100 before phase 20
RAGGED_ROWS = 1001                     # 3003 ints: not a multiple of 4

# NVIDIA H100 SXM data sheet: HBM3 rate, and the non-tensor fp32 rate
# (the table's nearest entry for the int32 ALU work these kernels do)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


# each phase's ceiling in wall seconds on one H100 80GB HBM3 at 700 W (the
# whole run from a cold build/ within 700 s); a phase's deadline is twice
# its ceiling, and no deadline lies past RUN_DEADLINE_S into the run
PHASE_CEILING_S = {"1-3": 15, "4": 55, "6-7": 50, "8": 45, "9": 30,
                   "10": 25, "11": 40, "12": 30, "13": 35, "14": 40,
                   "15": 90, "16": 30, "17": 55, "18": 20, "19": 30,
                   "20": 25, "5": 28}
RUN_DEADLINE_S = 950.0


def arm_deadline(phase: str, t_run: float, say: bool = True) -> float:
    """Re-arm the watchdog for `phase` of a run that began at `t_run`:
    past min(2 x its ceiling, RUN_DEADLINE_S less the seconds gone)
    faulthandler writes every thread's stack to stderr (the main thread's
    last, its outer frames name the phase's function) and ends the
    process with exit code 1, whatever the phase is doing. Prints
    "phase N: start at T s" unless `say` is false; the deadline in s."""
    import faulthandler
    gone = time.time() - t_run
    t = max(1.0, min(2.0 * PHASE_CEILING_S[phase], RUN_DEADLINE_S - gone))
    if say:
        log(f"phase {phase}: start at {gone:.1f} s, deadline in {t:.0f} s")
    faulthandler.dump_traceback_later(t, exit=True, file=sys.__stderr__)
    return t


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call of fn() over `reps` back-to-back calls, by CUDA
    events (includes the host's launch cost when that is the limit)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exact(got, want, what: str) -> int:
    """Raise unless two integer tensors are equal; returns max |diff| (0)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        bad = (got.long() - want.long()).abs().max().item() \
            if got.shape == want.shape else "shape"
        raise AssertionError(f"{what}: kernel != plain (max |diff| {bad}, "
                             f"{got.shape}/{want.shape}, "
                             f"{got.dtype}/{want.dtype})")
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_prefix_sum(dev) -> int:
    """Kernel 2 against torch.cumsum (int32) on the card, exact: every
    row kind, unaligned views, wraparound, epoch reuse over 2000 calls,
    state-buffer growth, and two streams at once."""
    import torch

    from emqx_tpu_torch.ops.scan import prefix_sum, prefix_sum_ref
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, lo=0, hi=3):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    err = 0

    def check(x, what):
        nonlocal err
        err = max(err, exact(prefix_sum(x), prefix_sum_ref(x),
                             f"prefix_sum {what}"))

    shapes = [(1,), (7,), (1000,), (1024,), (5000,), (16384,), (131072,),
              (262144,), (1 << 20,), (8, 131072), (8, 65536),
              (8, 65536 + 17), (1 << 24,), (1 << 20, 1), (4096, 8),
              (524288, 4), (8, 4), (524288, 16), (1000, 32), (1000, 33),
              (524288, 64), (1000, 1024), (1000, 1025), (32, 65536)]
    for shape in shapes:
        check(rand(shape, hi=2 if shape == (1 << 24,) else 3), shape)
    check(rand((3, 9000), -5, 6), "signed")
    cases = len(shapes) + 1
    # unaligned views: every row start off the 16-byte grid
    for shape in ((8, 65536), (1 << 20,), (1000, 64), (1000, 100),
                  (4096, 8), (1 << 20, 1)):
        flat = rand((int(np.prod(shape)) + 1,))
        check(flat[1:].view(shape), f"{shape} unaligned")
        cases += 1
    # running totals past 2^31 wrap as torch.cumsum's
    for shape in ((1 << 20,), (8, 65536 + 17), (1000, 64), (4096, 8)):
        check(rand(shape, 1 << 30, (1 << 31) - 1), f"{shape} wraparound")
        cases += 1
    # 2000 calls back to back on two alternating inputs, one state buffer
    ab, ys = (rand((262144,)), rand((262144,), 3, 9)), [None, None]
    for i in range(2000):
        ys[i % 2] = prefix_sum(ab[i % 2])
    for k in range(2):
        err = max(err, exact(ys[k], prefix_sum_ref(ab[k]),
                             f"prefix_sum call {1999 + k}"))
    # the state buffer grows between small, large and small calls
    for shape in ((5000,), (1 << 24,), (5000,), (8, 131072), (1 << 22,),
                  (3000,)):
        check(rand(shape, hi=2), f"{shape} growth")
    # two streams at once, each with its own state buffer
    xs = [rand((1 << 22,)), rand((8, 131072))]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs = [None, None]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(50):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k] = prefix_sum(xs[k])
    torch.cuda.synchronize()
    for k in range(2):
        err = max(err, exact(outs[k], prefix_sum_ref(xs[k]),
                             f"prefix_sum stream {k}"))
    torch.cuda.synchronize()
    log(f"phase 3: prefix_sum == torch.cumsum at {cases} shapes and views "
        f"(incl. unaligned and wraparound), over 2000 calls back to back, "
        f"across state-buffer growth and on two streams at once (exact)")
    return err


def check_shape_match(st, topics, lens, dollar, what: str) -> int:
    """Kernel fold planes and matches against fold_ref / probe_ref."""
    from emqx_tpu_torch.ops.fold import launch_shape_match
    from emqx_tpu_torch.ops.shapes import fold_ref, probe_ref
    m, c, *planes = launch_shape_match(st, topics, lens, dollar,
                                       fold_planes=True)
    ref = fold_ref(st, topics, lens, dollar)
    err = 0
    for name, a, b in zip(("h1", "h2", "b1", "b2", "compat"), planes, ref):
        err = max(err, exact(a, b, f"shape_match {what} {name}"))
    mr = probe_ref(st, *ref)
    err = max(err, exact(m, mr.matches, f"shape_match {what} matches"))
    err = max(err, exact(c, mr.counts, f"shape_match {what} counts"))
    n_hit = int((mr.counts > 0).sum())
    log(f"phase 3: shape_match == fold_ref/probe_ref on {what}: "
        f"{topics.shape[0]} topics x {st.shape_plus_mask.shape[0]} shape "
        f"slots, {n_hit} topics matched (exact)")
    return err


def pattern_check(dev) -> int:
    import torch

    from emqx_tpu_torch.convert import tables_from_numpy
    from emqx_tpu_torch.ops.fanout import build_subtable
    from emqx_tpu_torch.ops.shapes import build_shape_tables
    from emqx_tpu_torch.workloads import pattern_population
    rng = np.random.default_rng(SEED)
    _i, words, flens, t, tl, dol = pattern_population(
        rng, PATTERN_FILTERS, BATCH, L=8, scale=10)
    tl = tl.copy()
    tl[:1024] = 0                              # zero-length padding rows
    tb = tables_from_numpy(build_shape_tables(words, flens),
                           build_subtable(1, {}, {}, {}), dev)
    on = [torch.from_numpy(x).to(dev) for x in (t, tl, dol)]
    return check_shape_match(tb.shapes, *on,
                             f"{len(flens)}-filter six-pattern population")


def known_answer(rb, fid, F, n_shared, n_groups):
    """Every message of a window readback against the bench population:
    one match (fid), one normal row (fid, opts 1), and for a shared
    filter one pick among its group's 8 members. Returns the per-slot
    occurrences and raises on any difference or unfair round robin."""
    W, B = fid.shape
    if rb.row_overflow.any() or rb.overflow.any():
        raise AssertionError("bench window overflowed its capacities")
    sh = fid < n_shared
    c3 = rb.counts3
    if not ((c3[..., 0] == 1).all() and (c3[..., 1] == 1).all()
            and (c3[..., 2] == sh).all()):
        raise AssertionError("counts3 differ from the known answer")
    off = rb.offsets[:, :-1]
    w = np.arange(W)[:, None]

    def at(k):
        return rb.payload[w, np.minimum(off + k, rb.payload.shape[1] - 1)]

    if not ((at(0) == fid).all() and (at(1) == fid).all()
            and (at(2) == 1).all()):
        raise AssertionError("matched fid / normal row / opts differ")
    group = fid // 16
    member = at(4) - F - 8 * group
    if not ((at(3)[sh] == group[sh]).all() and (at(5)[sh] == 1).all()
            and ((member[sh] >= 0) & (member[sh] < 8)).all()):
        raise AssertionError("shared slot / member differ")
    picks = np.bincount(group[sh] * 8 + member[sh],
                        minlength=n_groups * 8).reshape(n_groups, 8)
    used = picks.sum(1) > 0
    spread = picks[used].max(1) - picks[used].min(1)
    if (spread > 1).any():
        raise AssertionError("round robin unfair within a window")
    return np.bincount(group[sh], minlength=n_groups)


def check_plans(plans, fid, F, n_shared) -> None:
    """RouteEngine.route() plans against the known answer."""
    flat = fid.reshape(-1)
    bad = 0
    for p, f in zip(plans, flat.tolist()):
        ok = (len(p.fids) == 1 and p.fids[0] == f and len(p.rows) == 1
              and p.rows[0] == f and p.opts[0] == 1 and not p.host)
        if f < n_shared:
            g = f // 16
            ok = ok and len(p.shared_slots) == 1 and p.shared_slots[0] == g \
                and 0 <= p.shared_rows[0] - F - 8 * g < 8
        else:
            ok = ok and len(p.shared_slots) == 0
        bad += not ok
    if bad:
        raise AssertionError(f"{bad} plans differ from the known answer")


def bench_engine(dev, subs: int, batch: int, window: int, seed: int):
    """The bench population behind a RouteEngine, one staged window and
    each message's known fid."""
    import torch

    from emqx_tpu_torch.engine import RouteEngine
    from emqx_tpu_torch.workloads import (bench_subtable, device_filter_set,
                                          device_topic_batch, expected_fids)
    t0 = time.time()
    fs = device_filter_set(subs)
    F = fs["ids"] * fs["nums"]
    sub_tbl, n_groups = bench_subtable(F, SHARED_PCT)
    eng = RouteEngine.from_columnar(
        fs["rows"], fs["lens"], sub_tbl, fs["intern"], device=dev,
        batch=batch, window=window, fanout_cap=FANOUT_CAP, slot_cap=SLOT_CAP,
        strategy="round_robin", max_levels=8, payload_cap=PAYLOAD_CAP)
    t_build = time.time() - t0
    rng = np.random.RandomState(seed)
    tps, tls, mhs = [], [], []
    for _ in range(window):
        tp, tl = device_topic_batch(fs, rng, batch)
        tps.append(tp)
        tls.append(tl)
        mhs.append(rng.randint(0, 1 << 30, batch).astype(np.int32))
    tp, tl, mh = np.stack(tps), np.stack(tls), np.stack(mhs)
    dl = np.zeros(tl.shape, bool)
    fid = expected_fids(fs, tp.reshape(-1, 8)).reshape(window, batch)
    staged = [torch.from_numpy(x).to(dev) for x in (tp, tl, dl, mh)]
    return {"fs": fs, "F": F, "n_groups": n_groups, "eng": eng,
            "n_shared": F * SHARED_PCT // 100, "fid": fid, "tp": tp,
            "tl": tl, "mh": mh, "staged": staged, "t_build": t_build}


def drive_main_path(b: dict, timed_windows: int) -> dict:
    """RouteEngine.route() on one window of topic strings (launch counts
    read around it), the same window on the kernel and plain paths from
    the same cursors, then timed windows with cursors threaded; every
    message of every window is checked against the known answer."""
    import torch

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.models.router_engine import route_window
    from emqx_tpu_torch.ops.scan import prefix_sum_ref
    from emqx_tpu_torch.ops.shapes import shape_match_ref
    from emqx_tpu_torch.workloads import topic_strings
    eng, fid, F = b["eng"], b["fid"], b["F"]
    n_shared, n_groups, staged = b["n_shared"], b["n_groups"], b["staged"]
    sync = torch.cuda.synchronize if eng.device.type == "cuda" \
        else (lambda: None)
    strings = topic_strings(b["fs"], b["tp"].reshape(-1, 8),
                            b["tl"].reshape(-1))
    cursors0 = eng.cursors.clone()
    sync()
    D.reset_launches()
    t0 = time.time()
    plans = eng.route(strings, msg_hash=b["mh"].reshape(-1))
    sync()
    launches = dict(D.LAUNCHES)
    shapes = dict(D.LAUNCH_SHAPES["prefix_sum"])
    t_route = time.time() - t0
    check_plans(plans, fid, F, n_shared)
    del plans, strings

    kw = dict(fanout_cap=FANOUT_CAP, slot_cap=SLOT_CAP,
              payload_cap=PAYLOAD_CAP)
    k_out = route_window(eng.tables, cursors0, *staged, eng.strategy, **kw)
    p_out = route_window(eng.tables, cursors0, *staged, eng.strategy,
                         match=shape_match_ref, scan=prefix_sum_ref, **kw)
    for name in k_out.res._fields:
        exact(getattr(k_out.res, name), getattr(p_out.res, name),
              f"window {name}")
    for name in k_out.compact._fields:
        exact(getattr(k_out.compact, name), getattr(p_out.compact, name),
              f"window compact {name}")
    exact(k_out.res.new_cursors[-1], eng.cursors, "route() cursors")
    del p_out
    n_entries = (k_out.compact.counts3 * torch.tensor(
        [1, 2, 3], dtype=torch.int32, device=eng.device)).sum(
            -1, dtype=torch.int32)

    occ = np.bincount((fid // 16)[fid < n_shared], minlength=n_groups)
    expect_cur = cursors0.cpu().numpy().astype(np.int64) + occ
    rb = eng.route_encoded(*staged)          # warm-up window, checked too
    expect_cur += known_answer(rb, fid, F, n_shared, n_groups)
    lat = []
    for _ in range(timed_windows):
        sync()
        t0 = time.perf_counter()
        rb = eng.route_encoded(*staged)
        lat.append(time.perf_counter() - t0)
        expect_cur += known_answer(rb, fid, F, n_shared, n_groups)
    if not np.array_equal(eng.cursors.cpu().numpy().astype(np.int64),
                          expect_cur):
        raise AssertionError("cursors did not thread through the windows")
    lat_ms = np.array(lat) * 1e3
    W, B = fid.shape
    return {"launches": launches, "shapes": shapes, "t_route": t_route,
            "n_entries": n_entries, "lat_ms": lat_ms,
            "mps": len(lat) * W * B / float(np.sum(lat)),
            "p50": float(np.percentile(lat_ms, 50)),
            "p99": float(np.percentile(lat_ms, 99))}


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_ms(fn, reps: int, warmup: bool = True):
    """Device time per call of fn(): torch.profiler's kernels and copies
    (the host's launch cost excluded), with the per-entry rows. Falls
    back to CUDA events around the calls when the profiler sees no
    device activity (rows then None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side entries only: the aten ops that launched them carry
    # the same time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _dev_us(e) > 0]
    if not rows:
        return cuda_ms(fn, reps), None
    return sum(_dev_us(e) for e in rows) / 1e3 / reps, rows


PS_KERNEL = re.compile(r"ps_(?:copy|short|mid|long)")
PROFILE_TRIES = 3


def scan_entries(rows) -> int:
    """Kernel 2's device entries among torch.profiler rows."""
    return sum(e.count for e in rows if PS_KERNEL.search(e.key))


def time_scan_shapes(dev, shapes: dict, where: str) -> list:
    """Kernel 2 at every shape one window launched it with: launches per
    window, device time (the profiler must show one kernel entry per
    call and nothing else), the byte bound, an empty kernel at the same
    grid (the launch floor, not the bound), torch.cumsum, and the wrapper
    call back to back. Inputs are 0/1 masks, as on the paths."""
    import torch

    from emqx_tpu_torch.ops.scan import empty_kernel, prefix_sum, scan_plan
    out = []
    for shape, count in sorted(shapes.items(), key=lambda kv: kv[0]):
        x = (torch.rand(shape, device=dev) < 0.5).to(torch.int32)
        n = shape[-1]
        plan = scan_plan(x.numel() // n, n, True)
        # one kernel entry per call and nothing else: 199 or 200 entries
        # for 200 calls (two kernels per call would show as 400). The
        # profiler now and then loses a larger share of the records of
        # such a run (169 of 200 once), so a short count is profiled
        # again, up to PROFILE_TRIES times in all
        seen = []
        for _ in range(PROFILE_TRIES):
            ms, rows = device_ms(lambda: prefix_sum(x), 200)
            if rows is None:
                break
            found = scan_entries(rows)
            others = [e.key for e in rows if not PS_KERNEL.search(e.key)]
            seen.append(found)
            if others or found > 200:
                raise AssertionError(f"prefix_sum {shape}: {found} kernel "
                                     f"entries for 200 calls, others "
                                     f"{others}")
            if found >= 199:
                break
        else:
            raise AssertionError(f"prefix_sum {shape}: {seen} kernel "
                                 f"entries for 200 calls")
        if len(seen) > 1:
            log(f"kernel prefix_sum {where} {tuple(shape)}: profiler "
                f"records lost, entries per 200 calls by try {seen}")
        entries = seen[-1] / 200 if seen else None
        d = {"shape": list(shape), "where": where,
             "launches_per_window": count, "ms": ms,
             "floor_ms": device_ms(lambda: empty_kernel(plan.grid, dev),
                                   200)[0],
             "library_ms": device_ms(lambda: torch.cumsum(
                 x, dim=-1, dtype=torch.int32), 50)[0],
             "call_ms": cuda_ms(lambda: prefix_sum(x), 200),
             "entries_per_call": entries,
             "plan": f"{plan.path} items {plan.items} vec {int(plan.vec)} "
                     f"tiles {plan.tiles} grid {plan.grid}"}
        d["bound_ms"], d["bound_by"] = bound_ms(2 * x.numel() * 4, x.numel())
        log(f"kernel prefix_sum {where} {tuple(shape)} x{count}/window "
            f"[{d['plan']}]: {ms:.4f} ms, {entries} kernel entries per call "
            f"(bound {d['bound_ms']:.4f} ms by {d['bound_by']}; empty-kernel "
            f"floor {d['floor_ms']:.4f} ms), torch.cumsum "
            f"{d['library_ms']:.4f} ms; {d['call_ms']:.4f} ms per wrapper "
            f"call back to back")
        out.append(d)
    return out


class _Child:
    """This script in a process of its own (``flag``: ``--ingress``,
    ``--overload`` or ``--scan-shapes``), started ahead of its turn: it
    loads torch, CUDA, the kernels and the broker, then waits for its
    JSON argument on stdin (``run``). Each configuration still runs alone
    in a fresh process; only its start-up overlaps what runs before it.
    A child whose parent is gone reads end-of-file and exits unrun."""

    def __init__(self, flag: str):
        self.flag = flag
        self.proc = subprocess.Popen(
            [sys.executable, __file__, flag], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def run(self, arg: str, timeout: float) -> tuple:
        """(exit code, stdout, stderr) of its run with `arg`."""
        try:
            out, err = self.proc.communicate(arg + "\n", timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            _out, err = self.proc.communicate()
            raise AssertionError(f"{self.flag} {arg}: no result within "
                                 f"{timeout} s: {err[-2000:]}") from None
        return self.proc.returncode, out, err


def _child_ready() -> None:
    """A waiting child's start-up: a CUDA context, the kernels and the
    host library loaded, the broker imported."""
    import torch

    import emqx_tpu_torch.broker.node  # noqa: F401
    from emqx_tpu_torch import native
    from emqx_tpu_torch.ops.build import build
    torch.zeros(1, device="cuda")
    build()
    native.available()


def time_scan_shapes_apart(groups: list, child=None) -> list:
    """time_scan_shapes at each (where, shapes) group in one process of
    its own (this script with ``--scan-shapes``, `child` where one was
    started ahead), its lines passed through. Late in a long run the profiler of this process lost kernel
    records at a small scan shape — 191 of 200 entries, three tries in a
    row (PERF.md), where a fresh process counts 200 of 200 at the same
    shape — so the shapes the later phases add are profiled in a fresh
    process, with the same check; one process for all of them (a fresh
    process a group cost its start-up each time)."""
    groups = [(where, shapes) for where, shapes in groups if shapes]
    if not groups:
        return []
    arg = json.dumps({"groups": [
        {"where": where, "shapes": [[list(k), v] for k, v in shapes.items()]}
        for where, shapes in groups]})
    rc, out, err = (child or _Child("--scan-shapes")).run(arg, 600)
    for line in out.splitlines()[:-1]:
        log(line)
    if rc != 0:
        raise AssertionError(
            f"kernel 2 timing at {[w for w, _s in groups]}'s shapes failed:"
            f"\n{out[-2000:]}{err[-4000:]}")
    return json.loads(out.splitlines()[-1])


def time_kernels(b: dict, n_entries) -> tuple:
    """Each kernel at the main path's shapes: its device time, its plain
    version's, a library call's where one computes the same function,
    and the bound from this run's inputs."""
    import torch

    from emqx_tpu_torch.ops.fold import launch_shape_match
    from emqx_tpu_torch.ops.scan import prefix_sum, prefix_sum_ref
    from emqx_tpu_torch.ops.shapes import BK, fold_ref, shape_match_ref
    st = b["eng"].tables.shapes
    tp, tl, dl, _mh = b["staged"]
    t8, l8, d8 = tp.reshape(-1, 8), tl.reshape(-1), dl.reshape(-1)
    n = t8.shape[0]
    NSc = st.shape_plus_mask.shape[0]
    sm = {"ms": device_ms(lambda: launch_shape_match(st, t8, l8, d8), 50)[0],
          "plain_ms": device_ms(lambda: shape_match_ref(st, t8, l8, d8),
                                5)[0],
          "library_ms": None}
    # bytes this run's data needs: the topics once, one bucket row per
    # compatible lane plus a second where the first row misses, outputs
    h1, h2, b1, _b2, compat = fold_ref(st, t8, l8, d8)
    rows1 = st.buckets[b1.long()]
    hit1 = ((rows1[..., :BK] == h1[..., None])
            & (rows1[..., BK:2 * BK] == h2[..., None])
            & (rows1[..., 2 * BK:] >= 0)).any(-1) & compat.bool()
    n_rows = int(compat.sum()) + int((compat.bool() & ~hit1).sum())
    del h1, h2, b1, compat, rows1, hit1
    sm_bytes = n * (t8.shape[1] * 4 + 4 + 1) + n_rows * 3 * BK * 4 \
        + n * NSc * 4 + n * 4
    # ~12 integer ops per folded level per hash pair, ~100 for seeds,
    # homes, compat and the slot compares
    slen = st.shape_len.clamp(min=0).long()
    sm_ops = n * int((12 * slen + 100).sum())
    sm["bound_ms"], sm["bound_by"] = bound_ms(sm_bytes, sm_ops)
    sm["bytes"], sm["rows"] = sm_bytes, n_rows
    ps = {"ms": device_ms(lambda: prefix_sum(n_entries), 200)[0],
          "plain_ms": device_ms(lambda: prefix_sum_ref(n_entries), 200)[0],
          "library_ms": device_ms(lambda: torch.cumsum(
              n_entries, dim=-1, dtype=torch.int32), 200)[0],
          "call_ms": cuda_ms(lambda: prefix_sum(n_entries), 200)}
    ps["bound_ms"], ps["bound_by"] = bound_ms(2 * n_entries.numel() * 4,
                                              n_entries.numel())
    ps["err"] = exact(prefix_sum(n_entries), prefix_sum_ref(n_entries),
                      "prefix_sum compact offsets")
    return sm, ps


def profile_window(label: str, fn, p50_ms: float, n: int = 3) -> None:
    """Where a window's device time goes: the ten largest device entries
    over n profiled windows, the device's idle share of the unprofiled
    p50 window (one stream, so device entries do not overlap), and kernel
    2's device entries against its wrapper calls (one each)."""
    from emqx_tpu_torch import device as D
    fn()
    seen = []
    for _ in range(PROFILE_TRIES):
        D.reset_launches()
        busy, rows = device_ms(fn, n, warmup=False)
        calls = D.LAUNCHES["prefix_sum"] / n
        if rows is None:
            log(f"{label}: the profiler saw no device time (not measured)")
            return
        entries = scan_entries(rows) / n
        seen.append(entries)
        # one kernel per wrapper call; a short count is a lost profiler
        # record (see time_scan_shapes) and is profiled again
        if entries >= calls:
            break
    if len(seen) > 1:
        log(f"{label}: profiler records lost, prefix_sum entries per "
            f"window by try {seen}")
    log(f"{label}: device busy {busy:.3f} ms per window, idle share "
        f"{1 - busy / p50_ms:.3f} of the p50 window {p50_ms:.3f} ms")
    for e in sorted(rows, key=_dev_us, reverse=True)[:10]:
        log(f"{label}:   {_dev_us(e) / 1e3 / n:9.3f} ms  "
            f"{e.count / n:6.1f}x  {e.key[:90]}")
    log(f"{label}: prefix_sum {entries:g} kernel entries per window for "
        f"{calls:g} wrapper calls")
    if entries != calls:
        raise AssertionError(f"{label}: prefix_sum kernel entries {entries} "
                             f"!= wrapper calls {calls} per window")


def check_ring_rotate(dev, E: int, dp: int, R: int) -> int:
    """Kernel 3 against its plain version (and torch.roll) for every hop
    count, at [E, 3] and at a ragged block, aligned and unaligned; and
    across two cards where there are two."""
    import torch

    from emqx_tpu_torch.ops.exchange import ring_rotate, ring_rotate_ref
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                             device=dev, dtype=torch.int32)

    err = 0
    cases = []
    for rows in (E, RAGGED_ROWS):
        n = dp * R * rows * 3
        cases.append((f"[{rows}, 3]", rand(n).view(dp, R, rows, 3)))
    cases.append((f"[{RAGGED_ROWS}, 3] unaligned",
                  rand(dp * R * RAGGED_ROWS * 3 + 1)[1:].view(
                      dp, R, RAGGED_ROWS, 3)))
    for what, x in cases:
        blocks = [[x[d, r] for r in range(R)] for d in range(dp)]
        for k in range(1, R):
            got = ring_rotate(blocks, k)
            want = ring_rotate_ref(blocks, k)
            rolled = torch.roll(x, k, dims=1)
            for d in range(dp):
                for r in range(R):
                    err = max(err, exact(got[d][r], want[d][r],
                                         f"ring_rotate {what} k={k}"))
                    exact(got[d][r], rolled[d, r], f"ring_rotate {what} "
                          f"k={k} vs torch.roll")
    torch.cuda.synchronize()
    log(f"phase 6: ring_rotate == ring_rotate_ref == torch.roll on a "
        f"{dp}x{R} grid, k = 1..{R - 1}, blocks {', '.join(c[0] for c in cases)}"
        f" (exact)")
    if torch.cuda.device_count() < 2:
        log("phase 6: peer check did not run: one card on this machine")
        return err
    a = rand(E * 3).view(E, 3)
    b = rand(E * 3).view(E, 3).to("cuda:1")
    got = ring_rotate([[a, b]], 1)
    want = ring_rotate_ref([[a, b]], 1)
    for r in range(2):
        err = max(err, exact(got[0][r], want[0][r], "ring_rotate peer"))
    exact(got[0][1].cpu(), a.cpu(), "ring_rotate peer cuda:0 -> cuda:1")
    torch.cuda.synchronize()
    log("phase 6: two-card ring (cuda:0 <-> cuda:1, peer writes) == plain "
        "(exact)")
    return err


def mesh_build(pop: dict, dev, batch: int, covering: bool = True):
    """A ShardedRouteEngine over the mesh population (covering on, the
    reference's default, or off)."""
    from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
    return ShardedRouteEngine.from_columnar(
        pop["filters"], pop["words"], pop["lens"], pop["sub_start"],
        pop["sub_row"], pop["sub_opts"], pop["intern"],
        n_devices=MESH_DEVICES, dp=MESH_DP, device=dev, batch=batch,
        subscription_covering=covering, **MESH_CAPS)


def mesh_engine(dev, subs: int, batch: int, seed: int) -> dict:
    """The mesh population behind a ShardedRouteEngine, one staged window
    and each message's expected session."""
    import torch

    from emqx_tpu_torch.workloads import mesh_population, mesh_topic_batch
    t0 = time.time()
    pop = mesh_population(subs, LEVEL_CAP)
    eng = mesh_build(pop, dev, batch)
    t_build = time.time() - t0
    tp, tl, want = mesh_topic_batch(pop, np.random.RandomState(seed), batch,
                                    LEVEL_CAP)
    staged = [torch.from_numpy(x).to(dev) for x in (
        tp, tl, np.zeros(batch, bool), np.zeros(batch, np.int32))]
    # population fid of every global fid the engine assigned
    fid_of = {f: i for i, f in enumerate(pop["filters"])}
    pop_fid = np.array([fid_of[f] for f in eng.filters], np.int64)
    return {"pop": pop, "eng": eng, "tp": tp, "tl": tl, "want": want,
            "staged": staged, "pop_fid": pop_fid, "t_build": t_build}


def check_mesh_records(rb, want, pop_fid) -> None:
    """One exchange-served window against the known answer: exactly one
    delivery per message, to its filter's session, naming that filter,
    with opts 1."""
    if not rb.served:
        raise AssertionError(f"window not served by the exchange: "
                             f"{rb.reason}")
    rec = rb.records[np.argsort(rb.records[:, 0], kind="stable")]
    B = want.shape[0]
    if rec.shape[0] != B or not (rec[:, 0] == np.arange(B)).all():
        raise AssertionError(f"{rec.shape[0]} deliveries for {B} messages")
    gfid = rec[:, 2] & 0xFFFFFF
    if not ((rec[:, 1] == want).all() and (pop_fid[gfid] == want).all()
            and ((rec[:, 2] >> 24) == 1).all()):
        raise AssertionError("exchange records differ from the known answer")


def time_mesh(eng, staged, want, pop_fid, timed_windows: int) -> dict:
    """Timed route_encoded windows of one staged window, each checked
    against the known answer."""
    import torch
    sync = torch.cuda.synchronize if eng.device.type == "cuda" \
        else (lambda: None)
    lat = []
    served = fell_back = 0
    for _ in range(timed_windows):
        sync()
        t0 = time.perf_counter()
        rb = eng.route_encoded(*staged)
        lat.append(time.perf_counter() - t0)
        served += rb.served
        fell_back += not rb.served
        check_mesh_records(rb, want, pop_fid)
    lat_ms = np.array(lat) * 1e3
    return {"lat_ms": lat_ms, "served": served, "fell_back": fell_back,
            "mps": len(lat) * want.shape[0] / float(np.sum(lat)),
            "p50": float(np.percentile(lat_ms, 50)),
            "p99": float(np.percentile(lat_ms, 99))}


def drive_mesh(m: dict, timed_windows: int) -> dict:
    import torch

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.ops.exchange import ring_rotate_ref
    from emqx_tpu_torch.ops.scan import prefix_sum_ref
    from emqx_tpu_torch.parallel.sharded import (make_exchange_step,
                                                 make_sharded_route_step)
    from emqx_tpu_torch.workloads import topic_strings
    eng, staged, want = m["eng"], m["staged"], m["want"]
    sync = torch.cuda.synchronize if eng.device.type == "cuda" \
        else (lambda: None)
    B = want.shape[0]
    rb = eng.route_encoded(*staged)          # warm-up: sizes the segments
    check_records_or_gather(eng, rb, want, m["pop_fid"])
    E = eng._choose_ecap(B)
    err_ring = check_ring_rotate(eng.device, E, eng.n_dp, eng.n_route) \
        if eng.device.type == "cuda" else 0

    strings = topic_strings(m["pop"], m["tp"], m["tl"])
    served0 = eng.stats["exchange_windows"]
    sync()
    D.reset_launches()
    t0 = time.time()
    plans = eng.route(strings, msg_hash=np.zeros(B, np.int32))
    sync()
    launches = dict(D.LAUNCHES)
    shapes = dict(D.LAUNCH_SHAPES["prefix_sum"])
    t_route = time.time() - t0
    if eng.stats["exchange_windows"] != served0 + 1:
        raise AssertionError(f"route() window not served: {eng.stats}")
    bad = sum(not (len(p.rows) == 1 and p.rows[0] == f and len(p.fids) == 1
                   and m["pop_fid"][p.fids[0]] == f and p.opts[0] == 1
                   and not p.host and len(p.shared_slots) == 0)
              for p, f in zip(plans, want.tolist()))
    if bad:
        raise AssertionError(f"{bad} mesh plans differ from the known answer")
    del plans, strings

    # the step's planes and the exchange against the plain path
    cur = eng.cursors.clone()
    res_k = eng.step(eng.tables, cur, *staged, eng.strategy)
    plain_step = make_sharded_route_step(eng.mesh, scan=prefix_sum_ref,
                                         **MESH_CAPS)
    res_p = plain_step(eng.tables, cur, *staged, eng.strategy)
    for name in res_k._fields:
        exact(getattr(res_k, name), getattr(res_p, name), f"mesh step {name}")
    del res_p
    planes = (res_k.matches, res_k.rows, res_k.opts, res_k.shared_sids,
              res_k.overflow)
    ex_k = eng.exchange_step(E)(*planes, eng.aux)
    ex_p = make_exchange_step(eng.mesh, seg_cap=E, scan=prefix_sum_ref,
                              rotate=ring_rotate_ref)(*planes, eng.aux)
    for name in ex_k._fields:
        err_ring = max(err_ring, exact(getattr(ex_k, name),
                                       getattr(ex_p, name),
                                       f"exchange {name}"))
    if int(ex_k.ok.min()) != 3:
        raise AssertionError(f"exchange ok {ex_k.ok.tolist()}")
    del ex_p

    # per-session delivery order: exchange vs the host gather, one window
    rb = eng.route_encoded(*staged)
    check_mesh_records(rb, want, m["pop_fid"])
    gathered = eng.gather(res_k)
    if not np.array_equal(eng.session_order(rb),
                          eng.session_order(gathered)):
        raise AssertionError("per-session order: exchange != host gather")
    n_sessions = int(np.unique(rb.records[:, 1]).size)
    del res_k, gathered

    return {"launches": launches, "shapes": shapes, "t_route": t_route,
            "E": E, "err_ring": err_ring, "n_sessions": n_sessions,
            **time_mesh(eng, staged, want, m["pop_fid"], timed_windows)}


def check_records_or_gather(eng, rb, want, pop_fid) -> None:
    """The warm-up window may fall back (the segment class is still cold);
    either way its deliveries equal the known answer."""
    if rb.served:
        check_mesh_records(rb, want, pop_fid)
        return
    check_mesh_records(rb._replace(served=True), want, pop_fid)
    log(f"phase 7: warm-up window fell back ({rb.reason}); its gather "
        f"equals the known answer")


def time_ring_rotate(eng, E: int) -> dict:
    """Kernel 3 at the main path's shape: one round over the dp x route
    grid of [E, 3] blocks, beside its plain version and torch.roll."""
    import torch

    from emqx_tpu_torch.ops.exchange import ring_rotate, ring_rotate_ref
    dp, R = eng.n_dp, eng.n_route
    x = torch.randint(0, 1 << 30, (dp, R, E, 3), device=eng.device,
                      dtype=torch.int32)
    y = torch.empty_like(x)
    blocks = [[x[d, r] for r in range(R)] for d in range(dp)]
    outs = [[y[d, r] for r in range(R)] for d in range(dp)]
    out = {"ms": device_ms(lambda: ring_rotate(blocks, 1, out=outs),
                           200)[0],
           "plain_ms": device_ms(lambda: ring_rotate_ref(blocks, 1,
                                                         out=outs), 200)[0],
           "library_ms": device_ms(lambda: torch.roll(x, 1, dims=1),
                                   200)[0],
           "call_ms": cuda_ms(lambda: ring_rotate(blocks, 1, out=outs),
                              200),
           "bytes": 2 * x.numel() * 4}
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], 0)
    return out


def mesh_phase(dev) -> tuple:
    """Phases 6 and 7; returns (ring_rotate's kernel entry, the mesh
    summary, kernel 2's per-shape timings on the mesh window)."""
    import torch
    kid = _Child("--scan-shapes")     # loads while the mesh builds
    m = mesh_engine(dev, MESH_SUBS, MESH_BATCH, SEED)
    eng = m["eng"]
    torch.cuda.synchronize()
    log(f"phase 7: {len(eng.filters)} filters over {eng.n_route} route "
        f"shards x {eng.n_dp} dp rows on {eng.device}; caps {eng.caps}; "
        f"built and uploaded in {m['t_build']:.1f} s")
    r = drive_mesh(m, MESH_TIMED)
    launches = r["launches"]
    log(f"phase 7: ShardedRouteEngine.route() of {MESH_BATCH} topic strings "
        f"in {r['t_route']:.2f} s incl. host encode and decode; every plan "
        f"equals the known answer; launches {launches}; E = {r['E']}")
    if launches["prefix_sum"] == 0 or launches["ring_rotate"] == 0:
        raise AssertionError(f"a mesh kernel was not launched: {launches}")
    log("phase 7: step planes and ExchangeResult == plain path (exact); "
        f"per-session order of {r['n_sessions']} sessions == host gather")
    log(f"phase 7: {MESH_TIMED} timed windows of {MESH_BATCH} topics: "
        f"{r['served']} served by the exchange, {r['fell_back']} fell back; "
        f"window latency (step + exchange + plan readback) p50 "
        f"{r['p50']:.3f} ms, p99 {r['p99']:.3f} ms, max "
        f"{r['lat_ms'].max():.3f} ms; {r['mps']:.0f} topic-matches/s")
    if r["fell_back"]:
        raise AssertionError("a timed mesh window fell back")
    log(f"phase 7: subscription_covering on: cover "
        f"{json.dumps(eng.stats['cover'])}; detection over every shard "
        f"{eng.detect_s:.2f} s")
    # the same windows with covering off, in the same call: what the
    # identity cover tables cost (nothing in this population is covered)
    t0 = time.time()
    off = mesh_build(m["pop"], dev, MESH_BATCH, covering=False)
    t_off = time.time() - t0
    staged = m["staged"]
    rb = off.route_encoded(*staged)          # warm-up: sizes the segments
    check_records_or_gather(off, rb, m["want"], m["pop_fid"])
    r_off = time_mesh(off, staged, m["want"], m["pop_fid"], MESH_TIMED)
    r_on = time_mesh(eng, staged, m["want"], m["pop_fid"], MESH_TIMED)
    if r_off["fell_back"] or r_on["fell_back"]:
        raise AssertionError("a timed mesh window fell back")
    log(f"phase 7: covering off (built in {t_off:.1f} s) vs on, "
        f"{MESH_TIMED} windows each, off then on: off p50 "
        f"{r_off['p50']:.3f} ms, p99 {r_off['p99']:.3f} ms, "
        f"{r_off['mps']:.0f} topic-matches/s; on p50 {r_on['p50']:.3f} ms, "
        f"p99 {r_on['p99']:.3f} ms, {r_on['mps']:.0f} topic-matches/s")
    del off
    profile_window("profile mesh", lambda: eng.route_encoded(*staged),
                   r["p50"])
    rr = time_ring_rotate(eng, r["E"])
    log(f"kernel ring_rotate {eng.n_dp}x{eng.n_route} x [{r['E']}, 3]: "
        f"{rr['ms']:.4f} ms (bound {rr['bound_ms']:.4f} ms by "
        f"{rr['bound_by']}: {rr['bytes'] / 1e6:.2f} MB), plain "
        f"{rr['plain_ms']:.4f} ms, torch.roll {rr['library_ms']:.4f} ms; "
        f"{rr['call_ms']:.4f} ms per wrapper call back to back")
    # in a process of its own, as phase 9's: late in this long run the
    # profiler lost records at a mesh shape (196 of 200 at [2, 4, 4], three
    # tries in a row, PERF.md)
    scan_shapes = time_scan_shapes_apart([("mesh", r["shapes"])], kid)
    kernel = {"name": "ring_rotate", "route": "cuda",
              "source": "emqx_tpu_torch/csrc/ring_rotate.cu",
              "replaces": "emqx_tpu/ops/pallas_exchange.py:98",
              "launches": launches["ring_rotate"],
              "max_abs_err": r["err_ring"],
              **{k: rr[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}
    summary = {"subs": len(eng.filters), "batch": MESH_BATCH,
               "dp": eng.n_dp, "route": eng.n_route, "seg_cap": r["E"],
               "timed_windows": MESH_TIMED, "served": r["served"],
               "fell_back": r["fell_back"],
               "topic_matches_per_s": r["mps"], "window_p50_ms": r["p50"],
               "window_p99_ms": r["p99"],
               "window_max_ms": float(r["lat_ms"].max()),
               "route_call_s": r["t_route"], "launches": launches,
               "cover": eng.stats["cover"], "detect_s": eng.detect_s,
               "covering_off": {k: r_off[k] for k in ("p50", "p99", "mps")},
               "covering_on_again": {k: r_on[k] for k in ("p50", "p99",
                                                           "mps")}}
    return kernel, summary, scan_shapes


# ---- phase 8: the broker's serving path over live TCP --------------------

E2E_FILTERS = 100_000      # bench.py run_e2e(100_000, 16, 8, 32_000 // 8)
E2E_SUB_CONNS = 16
E2E_PUB_CONNS = 8
E2E_MSGS = 16_000          # the bench's 32,000, cut for time before phase 20
# the population of the phases that are not a main path (14, 15d, 15c's
# mesh leg, 16, 18, 19, 20): a quarter of phase 8's (all of it before
# QUIC), so the run fits its 700 s
PART_FILTERS = E2E_FILTERS // 4
E2E_SUB_CHUNK = 512        # filters per SUBSCRIBE packet
E2E_MIN_DEVICE_SHARE = 0.9
# (label, dispatch depth, delivery lanes on, observability layers,
# supervised) of each flood, in order; the layers: "on" the flight
# recorder and the latency observatory, "off" neither, "obs" the
# observatory alone, "quiet" both with an objective no message breaches
# (no slo_breach event, no exemplar)
E2E_RUNS = (("d2", 2, True, "on", True), ("d1", 1, True, "on", True),
            ("d2-inline", 2, False, "on", True),
            ("d2-untraced", 2, True, "off", True))
# phase 8's supervision round: the depth-2 lanes flood with the node's
# supervisor detached (what ``supervise: false`` builds) against the same
# flood supervised ("d2"), run after "d2" (three rounds before phase 18,
# two before phase 20: the others are cut for time)
E2E_SUPERVISE_RUNS = (
    ("d2-unsupervised-1", 2, True, "on", False),)
# the --trace-cost floods: the four layer settings at depth 2 with the
# lanes, in TRACE_ROUNDS rounds, each round's order rotated by one
TRACE_LAYERS = ("on", "off", "quiet", "obs")
TRACE_ROUNDS = 8


def e2e_grid(n_filters: int) -> tuple:
    """bench.py's e2e population: ids x nums filters device/d{i}/+/n{n}/#,
    SHARED_PCT of them in 2-member $share/bg groups."""
    ids = max(8, int(np.sqrt(n_filters)))
    return ids, max(1, n_filters // ids)


def e2e_shared(i: int, n: int, nums: int) -> bool:
    return (i * nums + n) % 100 < SHARED_PCT


# (total, staging + replay, readback staging) seconds per serving dispatch
_DISPATCHES: list = []


def _time_dispatches(eng) -> None:
    """Record each serving dispatch's host time, and the parts of it spent
    staging its inputs and replaying the graph (``_replay``) and starting
    its pinned readback (``_pinned``): what a slow window waited on (the
    rest is the engine lock and the eager path)."""
    import threading
    cur = {"thread": None}

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if cur["thread"] == threading.get_ident():
                    cur[key] += time.perf_counter() - t0
        return call

    eng._replay = timed(eng._replay, "replay")
    eng._pinned = timed(eng._pinned, "pin")
    dispatch = eng.dispatch

    def timed_dispatch(h):
        cur.update(thread=threading.get_ident(), replay=0.0, pin=0.0)
        t0 = time.perf_counter()
        try:
            dispatch(h)
        finally:
            cur["thread"] = None
            _DISPATCHES.append((time.perf_counter() - t0, cur["replay"],
                                cur["pin"]))

    eng.dispatch = timed_dispatch


async def _subscribe_population(port, n_filters: int, n_sub: int,
                                login=None, make=None):
    """bench.py:1219-1243: each subscriber connection takes its own plain
    filters and shared groups, plus the second membership of the previous
    connection's groups (2 members per group on different sockets), in
    SUBSCRIBE packets of E2E_SUB_CHUNK filters. Every connection is made
    before the first SUBSCRIBE: the subscriptions can hold the loop long
    enough for a polled governor to pause CONNECTs. A list of ports
    spreads the connections over nodes, connection c on port c % len.
    ``login(c)``: connection c's CONNECT credentials (username,
    password). ``make(c, clientid)``: connection c's Client where it is
    not a TCP one (None: TCP), connected under a deadline."""
    import asyncio

    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.mqtt import packet as P
    ids, nums = e2e_grid(n_filters)
    ports = list(port) if isinstance(port, (list, tuple)) else [port]
    subs, n_shared, n_entries = [], 0, 0
    for c in range(n_sub):
        cl = make(c, f"esub{c}") if make else None
        if cl is not None:
            subs.append(cl)
            await asyncio.wait_for(cl.connect(), 60)
            continue
        subs.append(Client(port=ports[c % len(ports)], clientid=f"esub{c}",
                           **(login(c) if login else {})))
        await subs[-1].connect()
    batches = [[] for _ in range(n_sub)]
    for c, f, qos, second in _population(ids, nums, n_sub):
        n_shared += qos == 1 and not second
        batches[c].append((f, P.SubOpts(qos=qos)))
    for c, (cl, batch) in enumerate(zip(subs, batches)):
        for k in range(0, len(batch), E2E_SUB_CHUNK):
            ack = await cl.subscribe(batch[k:k + E2E_SUB_CHUNK], timeout=60)
            if any(rc >= 0x80 for rc in ack.reason_codes):
                raise AssertionError(f"esub{c}: a SUBSCRIBE was refused")
        n_entries += len(batch)
    return subs, ids, nums, n_shared, n_entries


async def _warm_up(node, pub, subs, nums: int) -> None:
    """bench.py:1254-1280: 64 publishes through the node, the full-size
    batch class through route_batch, then wait for the snapshot and its
    fused window class (the batcher routes host-side until the classes
    are warm)."""
    import asyncio

    from emqx_tpu_torch.broker.message import make
    for k in range(64):
        await pub.publish(f"device/d0/x/n{k % nums}/t", b"w", qos=0)
    for _ in range(200):
        await asyncio.sleep(0.05)
        if sum(cl.messages.qsize() for cl in subs) >= 64:
            break
    for cl in subs:
        while not cl.messages.empty():
            cl.messages.get_nowait()
    eng = node.device_engine
    eng.route_batch([make("w", 0, "warmup/none/t", b"")
                     for _ in range(1024)])
    # a large first snapshot builds in the background (route_batch then
    # declines): wait for it, its fused window class, and the background
    # warm of the other standard classes (a serving dispatch waits for
    # the engine lock a capture holds, and the chooser's first device
    # sample would carry that wait)
    for _ in range(1200):
        b = eng._built
        if b is not None and (b.backend != "shapes" or eng.max_fuse() > 1) \
                and getattr(eng, "_fuse_warm_task", None) is None:
            break
        await asyncio.sleep(0.05)
    if eng._built is None:
        raise AssertionError("no snapshot after the warm-up")


def flood_pairs(seed: int, p: int, per_pub: int, ids: int,
                nums: int) -> list:
    """Publisher p's (i, n) sequence in ``_flood``: its k-th message goes
    to device/d{i}/x/n{n}/t."""
    r = np.random.RandomState(seed + p)
    return [(int(r.randint(0, ids)), int(r.randint(0, nums)))
            for _ in range(per_pub)]


async def _flood(node, subs, pubs, ids: int, nums: int, total: int,
                 seed: int, replays: bool = False,
                 per_topic: bool = False, groups=None,
                 retain_every: int = 0, others=(),
                 forbidden: int = 0) -> dict:
    """bench.py:1283-1366: every publisher floods its share of `total`
    messages to device/d{i}/x/n{n}/t (each matches exactly one filter),
    every 4th at QoS 1 with pipelined PUBACKs; drainers record every
    delivery. Checks exactly-once delivery to the right connection and
    per-publisher order at every subscriber. ``replays``: the supervisor
    may replay windows on the host (a chaos flood), so failed device
    stages (``routing.device.dispatch_failed``) are allowed; a failed
    engine never is. ``per_topic``: the order is held per publisher and
    topic (MQTT's ordered topic), as the mesh's consume orders a window's
    deliveries by source shard (a session's filters on two shards may
    receive a publisher's two messages in shard order). ``groups``
    ({label: publisher indices}, e.g. by transport): each group's
    delivered msgs/s (its messages over the time to its last delivery)
    and client p50 / p99 as ``by_group``. ``retain_every``: every
    such k-th message of a publisher carries the retain flag. ``others``:
    the other nodes of a cluster the clients are spread over; their
    engines must not fail either, and their sessions' queues count for
    the order's per-QoS key (the counters read are `node`'s, the fault
    counters every node's). ``forbidden``: that many more QoS 1
    PUBLISHes to device/d{i}/forbidden/... (an ACL denies them), spread
    evenly over the publishers' streams; their PUBACK reason codes are
    returned as ``forbidden_rcs``."""
    import asyncio
    import struct

    from emqx_tpu_torch import device as D
    n_sub, n_pub = len(subs), len(pubs)
    per_pub = total // n_pub
    got = [[] for _ in range(n_sub)]   # (pub, seq, i, n, qos) per conn
    lat: list[float] = []
    lat_pub: list[int] = []
    last_seen = [0.0] * n_pub          # time of a publisher's last delivery
    fmt = "<dIIII"

    async def drain(c, cl):
        while True:
            m = await cl.messages.get()
            t, p, s, i, n = struct.unpack(fmt, m.payload)
            now = time.perf_counter()
            lat.append(now - t)
            lat_pub.append(p)
            last_seen[p] = now
            got[c].append((p, s, i, n, m.qos))

    n_fb = [forbidden // n_pub + (p < forbidden % n_pub)
            for p in range(n_pub)]
    fb_acks = []

    async def acked(p, cl, acks):
        """Publisher p's PUBACKs, 60 s at most; past that, how many are
        owed and, for a QUIC client, its connection's state."""
        done, owed = await asyncio.wait(acks, timeout=60)
        if owed:
            quic = getattr(cl, "quic", None)
            raise AssertionError(
                f"publisher {p} ({cl.clientid}): {len(owed)} of "
                f"{len(acks)} PUBACKs owed after 60 s"
                + (f"; QUIC {json.dumps(quic_state(quic))}" if quic else ""))
        for a in done:
            a.result()              # a PUBACK that failed fails the flood

    async def flood(p, cl):
        acks = []
        fb_at = {(j + 1) * per_pub // (n_fb[p] + 1): j
                 for j in range(n_fb[p])}
        for k, (i, n) in enumerate(flood_pairs(seed, p, per_pub, ids,
                                               nums)):
            if k in fb_at:
                fb_acks.append(cl.publish_start(
                    f"device/d{i}/forbidden/p{p}/{fb_at[k]}", b"denied",
                    qos=1))
            fut = cl.publish_start(
                f"device/d{i}/x/n{n}/t",
                struct.pack(fmt, time.perf_counter(), p, k, i, n),
                qos=1 if k % 4 == 0 else 0,
                retain=bool(retain_every) and k % retain_every == 0)
            if fut is not None:
                acks.append(fut)
            if len(acks) >= 256:
                await acked(p, cl, acks)
                acks.clear()
            if cl.needs_drain:
                await cl.drain()
            if k % 64 == 63:
                await asyncio.sleep(0)
        if acks:
            await acked(p, cl, acks)

    m = node.metrics
    stages = ("prepare", "dispatch", "card", "readback", "consume")
    # a device failure raises on the card; these stay 0 on every node or
    # the flood left the kernels without saying so
    faults = ("routing.device.dispatch_failed",
              "routing.device.rebuild_failed",
              "routing.device.host_fallback")
    faults0 = [{k: nd.metrics.val(k) for k in faults}
               for nd in (node, *others)]
    before = {k: m.val(k) for k in (
        "messages.routed.device", "routing.device.batches",
        "routing.device.windows", "routing.device.bypassed",
        "routing.device.compact_overflow",
        "routing.device.messages", "routing.host.route_us",
        "routing.host.messages", "pipeline.deliver.rows",
        "pipeline.deliver.plans", *INGRESS_COUNTERS, *faults,
        *LAYER_COUNTERS,
        *(f"routing.device.{s}_us" for s in stages))}
    # (the host-only node has no batcher; the JAX reference's batcher,
    # driven by the CPU tests, keeps no samples and its engine no
    # `failed`)
    pb = node.publish_batcher
    if pb is not None:
        pb.route_lat.clear()
    samples = getattr(pb, "cost_samples", {})
    wins = getattr(pb, "window_costs", [])
    for q in (*samples.values(), wins):
        q.clear()
    drainers = [asyncio.get_running_loop().create_task(drain(c, cl))
                for c, cl in enumerate(subs)]
    D.reset_launches()
    _DISPATCHES.clear()
    t0 = time.time()
    t0_perf = time.perf_counter()
    try:
        await asyncio.gather(*[flood(p, cl) for p, cl in enumerate(pubs)])
        fb_rcs = [a.reason_code for a in await asyncio.wait_for(
            asyncio.gather(*fb_acks), 60)]
        deadline = time.time() + 120
        while sum(map(len, got)) < per_pub * n_pub \
                and time.time() < deadline:
            await asyncio.sleep(0.01)
        dt = time.time() - t0
        await asyncio.sleep(0.2)         # a duplicate would land by now
    finally:
        for d in drainers:
            d.cancel()
    launches = dict(D.LAUNCHES)
    delta = {k: m.val(k) - v for k, v in before.items()}
    sent = per_pub * n_pub
    q1_sent = n_pub * len(range(0, per_pub, 4))
    failed = getattr(node.device_engine, "failed", None)
    for o in others:
        failed = failed or getattr(o.device_engine, "failed", None)
    fdelta = {k: sum(nd.metrics.val(k) - f0[k]
                     for nd, f0 in zip((node, *others), faults0))
              for k in faults}
    if failed is not None or any(
            fdelta[k] for k in faults
            if not (replays and k == "routing.device.dispatch_failed")):
        raise AssertionError(
            f"the device path failed during the flood: {fdelta}, "
            f"engine {failed!r}")

    seen = np.zeros((n_pub, per_pub), np.int64)
    wrong_conn = 0
    queued = any(getattr(ch.session, "enqueue_count", 0)
                 for nd in (node, *others)
                 for _cid, ch in nd.cm.all_channels()
                 if getattr(ch, "session", None) is not None)
    for c, rows in enumerate(got):
        last = {}
        for p, s, i, n, qos in rows:
            seen[p, s] += 1
            own = i % n_sub
            shared = e2e_shared(i, n, nums)
            ok = {own, (own + 1) % n_sub} if shared else {own}
            wrong_conn += c not in ok
            # publish order per publisher at this subscriber, held per
            # delivery class: the consume delivers a window's clean
            # messages (plain filters) before its shared-group ones, the
            # reference's ordering contract (emqx_tpu/broker/deliver.py
            # :50-55, per-topic order as MQTT requires). A QoS 1 delivery
            # waiting for the session's inflight window may also let a
            # later QoS 0 one pass (MQTT orders per QoS), so when any
            # session queued, the order is held per QoS too
            key = (p, shared, qos) if queued else (p, shared)
            if per_topic:
                key += (i, n)
            if last.get(key, -1) >= s:
                raise AssertionError(
                    f"esub{c}: publisher {p} out of order ({s} after "
                    f"{last[key]}, shared={shared})")
            last[key] = s
    if (seen != 1).any():
        raise AssertionError(
            f"exactly-once violated: {int((seen == 0).sum())} lost, "
            f"{int((seen > 1).sum())} duplicated of {sent}")
    if wrong_conn:
        raise AssertionError(f"{wrong_conn} deliveries to a connection "
                             f"that does not hold the filter")
    lat_ms = np.sort(np.array(lat)) * 1e3
    by_group = None
    if groups:
        lat_a, pub_a = np.array(lat) * 1e3, np.array(lat_pub)
        by_group = {}
        for label, ps in groups.items():
            g = lat_a[np.isin(pub_a, ps)]
            by_group[label] = {
                "publishers": len(ps), "sent": per_pub * len(ps),
                "per_sec": int(round(per_pub * len(ps) / (
                    max(last_seen[p] for p in ps) - t0_perf))),
                "lat_p50_ms": float(np.percentile(g, 50)),
                "lat_p99_ms": float(np.percentile(g, 99))}
    return {"sent": sent, "by_group": by_group, "q1_sent": q1_sent, "delivered": int(seen.sum()),
            "wall_s": dt, "per_sec": int(round(int(seen.sum()) / dt)),
            "device_routed": delta["messages.routed.device"],
            "batches": delta["routing.device.batches"],
            "device_bypassed": delta["routing.device.bypassed"],
            "windows": delta["routing.device.windows"],
            "compact_overflow": delta["routing.device.compact_overflow"],
            "lane_rows": delta["pipeline.deliver.rows"],
            "lane_plans": delta["pipeline.deliver.plans"],
            "ingress": ingress_numbers(delta),
            "layers": layer_numbers(delta),
            # host time per message of each stage of the device path (the
            # card's time per message under "card"), and of the host path
            "device_us_per_msg": {
                s: delta[f"routing.device.{s}_us"]
                / max(1, delta["routing.device.messages"]) for s in stages},
            "host_us_per_msg": delta["routing.host.route_us"]
            / max(1, delta["routing.host.messages"]),
            "lat_p50_ms": float(np.percentile(lat_ms, 50)),
            "lat_p99_ms": float(np.percentile(lat_ms, 99)),
            "route_lat": pb.lat_percentiles() if pb is not None else None,
            "launches": launches, "order_per_qos": queued,
            "forbidden_rcs": fb_rcs,
            "dev_msg_us": (getattr(pb, "_dev_msg_s", 0) or 0) * 1e6,
            "host_msg_us": (getattr(pb, "_host_msg_s", 0) or 0) * 1e6,
            "samples_us": {k: _spread(q) for k, q in samples.items()},
            # the device windows' own cost a message, by window size (the
            # chooser pools the small ones: batcher._device_sample)
            "small_window": pb.max_batch // 4 if pb is not None else None,
            "window_us": {
                size: _spread([c / n for n, c in wins
                               if (n < pb.max_batch // 4) == (size == "small")])
                for size in ("small", "full")},
            "dispatch_ms": {
                "n": len(_DISPATCHES),
                "sum": sum(d[0] for d in _DISPATCHES) * 1e3,
                "slowest": [[round(x * 1e3, 3) for x in d]
                            for d in sorted(_DISPATCHES, reverse=True)[:3]]},
            "got": got}


# the columnar ingress counters a flood reads around its run
INGRESS_COUNTERS = (
    "pipeline.ingress.bursts", "pipeline.ingress.rows",
    "pipeline.ingress.fallback_frames", "pipeline.ingress.bytes",
    "packets.publish.received")


def ingress_numbers(delta: dict) -> dict:
    """The columnar ingress over one run: bursts, their PUBLISH rows, the
    frames that took the per-packet path, the share of the PUBLISHes that
    came in bursts and the rows per burst."""
    out = {k.rsplit(".", 1)[1]: delta[k] for k in INGRESS_COUNTERS}
    pubs = delta["packets.publish.received"]
    out["burst_share"] = delta["pipeline.ingress.rows"] / pubs \
        if pubs else None
    out["rows_per_burst"] = (delta["pipeline.ingress.rows"]
                             / delta["pipeline.ingress.bursts"]) \
        if delta["pipeline.ingress.bursts"] else None
    return out


# the routing layers' counters each drive reads around its run
LAYER_COUNTERS = (
    "routing.device.cached_windows", "routing.device.cold_cached_class",
    "routing.device.cold_delta_class", "routing.device.cold_compact_class",
    "routing.device.eager_windows", "routing.device.delta_applies",
    "routing.device.host_delta", "routing.device.dedup_lanes",
    "routing.device.dedup_unique", "routing.device.rebuilds",
    "routing.device.compactions", "match_cache.hits", "match_cache.misses")


# host time of each stage of the device path (card: the stream's span,
# readback: materialize's host part on the card, its whole on the CPU)
STAGE_US = tuple(f"routing.device.{s}_us" for s in (
    "prepare", "dispatch", "card", "readback", "materialize", "consume"))


def stage_us(delta: dict) -> dict:
    """Microseconds per device-routed message of each stage."""
    per = max(1, delta["routing.device.messages"])
    return {k.split(".")[-1][:-3]: delta[k] / per for k in STAGE_US}


def layer_numbers(delta: dict) -> dict:
    """The routing layers' counters over one run, the cache hit rate and
    the dedup ratio (publish lanes per unique topic in the windows whose
    dedup plan engaged)."""
    out = {k.rsplit(".", 1)[1] if k.startswith("routing") else k: delta[k]
           for k in LAYER_COUNTERS}
    look = delta["match_cache.hits"] + delta["match_cache.misses"]
    out["hit_rate"] = delta["match_cache.hits"] / look if look else None
    out["dedup_ratio"] = (delta["routing.device.dedup_lanes"]
                          / delta["routing.device.dedup_unique"]) \
        if delta["routing.device.dedup_unique"] else None
    return out


def _spread(samples) -> dict:
    """The chooser's samples of one path over a flood (us per message):
    their count and quantiles."""
    a = np.asarray(samples, np.float64) * 1e6
    if not a.size:
        return {"n": 0}
    return {"n": int(a.size), **{k: float(np.percentile(a, p)) for k, p in
                                 (("min", 0), ("p10", 10), ("p50", 50),
                                  ("p90", 90), ("max", 100))}}


def tele_state(node) -> tuple:
    """The node's telemetry state (histogram buckets, counters, graph
    captures by class), for tele_delta."""
    t = node.pipeline_telemetry
    hs = {k: (list(h.counts), h.sum, h.count)
          for k, h in node.metrics.histograms().items()}
    return hs, dict(node.metrics.all()), \
        {k: dict(v) for k, v in t.compiles_by_shape.items()}


def tele_delta(node, before: tuple) -> dict:
    """The telemetry snapshot's stages, decisions and graph captures over
    what ran since `before` (tele_state): the same snapshot code on a
    registry holding the differences."""
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.broker.telemetry import PipelineTelemetry
    hs0, c0, comp0 = before
    d = Metrics()
    for k, h in node.metrics.histograms().items():
        counts, s0, n0 = hs0.get(k, ([0] * len(h.counts), 0.0, 0))
        dh = d.hist(k, lo=h.lo, n_buckets=len(h.bounds), unit=h.unit,
                    substeps=h.substeps)
        dh.counts = [a - b for a, b in zip(h.counts, counts)]
        dh.sum, dh.count = h.sum - s0, h.count - n0
    for k, v in node.metrics.all().items():
        d.inc(k, v - c0.get(k, 0))
    t = PipelineTelemetry(d)
    for label, row in node.pipeline_telemetry.compiles_by_shape.items():
        r0 = comp0.get(label, {"count": 0, "total_s": 0.0})
        if row["count"] > r0["count"]:
            t.compiles_by_shape[label] = {
                "count": row["count"] - r0["count"],
                "total_s": row["total_s"] - r0["total_s"]}
            t.compiles += row["count"] - r0["count"]
            t.compile_s += row["total_s"] - r0["total_s"]
    snap = t.snapshot()
    return {k: snap[k] for k in ("stages", "decisions", "compiles")}


def ledger_line(node, allocated_before) -> dict:
    """The HBM ledger's numbers after the floods: live bytes by category,
    the true peak, the static buffers of each graph class, and the
    accounted share of the card's allocated bytes (None on the CPU) —
    of all of them, and of what was allocated since `allocated_before`
    (the bytes earlier phases left on the card when this one began)."""
    sec = node.hbm_ledger.section()
    cats = sec["categories"]
    alloc = (sec.get("device") or {}).get("allocated_bytes.all.current")
    since = alloc - allocated_before if alloc is not None else None
    return {"live_bytes": sec["live_bytes"], "peak_bytes": sec["peak_bytes"],
            "by_category": {k: c["live_bytes"] for k, c in cats.items()},
            "pipeline_buffers_by_class": cats.get(
                "pipeline_buffers", {}).get("owners", {}),
            "accounted_fraction": sec.get("accounted_fraction"),
            "memory_allocated": alloc, "allocated_before": allocated_before,
            "accounted_of_phase": round(
                node.hbm_ledger.device_live_bytes() / since, 4)
            if since else None,
            "pins": sec["pins"]}


def _host_allocs(dev) -> "int | None":
    """Pinned host blocks the caching host allocator has created so far
    (None on the CPU or where this torch does not count them)."""
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if dev.type != "cuda" or stats is None:
        return None
    return int(stats().get("num_host_alloc", 0))


async def _profiled_flood(node, subs, pubs, ids: int, nums: int,
                          total: int, seed: int) -> dict:
    """One flood under the engine's device trace (``start_device_trace``,
    torch.profiler): the card's busy time (kernels and copies, summed by
    the profiler) against the flood's wall time, and the join of the
    capture's ``route_step#<trace id>`` ranges with the flight recorder.
    The node's recorder is one whose ring holds the whole flood (at the
    2 ms objective every message's ``slo_breach`` event takes a slot, so
    the default 4,096 slots hold its last windows only): nothing may be
    overwritten, and every range must name a trace the ring holds a
    dispatch span under — a set inclusion, as the profiler can lose
    records late in a long run (a range names the lead's trace, never a
    fused follower's)."""
    import torch
    eng = node.device_engine
    rec = node.flight_recorder
    torch.cuda.synchronize()
    if not eng.start_device_trace():
        raise AssertionError("a device trace was already running")
    try:
        t0 = time.time()
        f = await _flood(node, subs, pubs, ids, nums, total, seed)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        prof = eng.stop_device_trace()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _dev_us(e) > 0]
    busy = sum(_dev_us(e) for e in rows) / 1e6
    top = sorted(rows, key=_dev_us, reverse=True)[:6]
    steps = [e.name for e in prof.events()
             if e.name.startswith("route_step#")]
    ids_named = {int(n.split("#", 1)[1]) for n in steps}
    if rec.dropped():
        raise AssertionError(f"the profiled flood's ring ({rec.cap} slots) "
                             f"overwrote {rec.dropped()} spans")
    held = {s.trace_id for s in rec.spans()
            if s.name in ("dispatch", "dispatch_cached")}
    if not ids_named:
        raise AssertionError("the device trace holds no route_step range")
    if not ids_named <= held:
        raise AssertionError(
            f"{len(ids_named - held)} route_step ranges name no trace the "
            f"ring holds a dispatch span under (e.g. "
            f"{sorted(ids_named - held)[:5]})")
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "windows": f["windows"],
            "per_sec": f["per_sec"], "route_steps": len(steps),
            "route_step_traces": len(ids_named),
            "dispatched_traces": len(held), "ring": rec.state(),
            "top": [(e.key[:60], round(_dev_us(e) / 1e3, 3), e.count)
                    for e in top]}


def _observability(node, rec, obs) -> None:
    """Point every holder of the node's flight recorder and latency
    observatory at `rec` and `obs`; None for both is what a node built
    with ``trace`` and ``latency_observatory`` off holds (the untraced
    flood detaches them, as the inline flood detaches the lane pool)."""
    node.flight_recorder = node.publish_batcher.rec = rec
    node.device_engine.rec = node.pipeline_telemetry.recorder = rec
    node.latency_observatory = node.publish_batcher.obs = obs
    node.pipeline_telemetry.observatory = node.broker.latency_obs = obs
    for holder in (node.hbm_ledger, node.overload_governor, obs,
                   node.supervisor):
        if holder is not None:
            holder.recorder = rec


def _objective(obs, ms: float) -> None:
    """Set the latency observatory's routed p99 objective (the breach
    threshold) to `ms`."""
    obs.objective_ms, obs._objective_s = ms, ms / 1000.0


def _supervision(node, sup, lanes) -> None:
    """Point every holder of the node's supervisor at `sup`; None is what
    a node built with ``supervise: false`` holds (the unsupervised flood
    detaches it, as the inline flood detaches the lane pool). `lanes` is
    the node's own lane pool (detached or not)."""
    node.supervisor = node.publish_batcher.sup = sup
    node.device_engine.sup = sup
    if lanes is not None:
        lanes.sup = sup
    node.pipeline_telemetry.supervise_state_fn = \
        sup.state if sup is not None else None


# the supervisor's counters that must stay 0 on a path that passes: a
# node of phases 8-12 runs supervised (the default) and ends its phase
# with none of them, so supervision hides no device fault there
SUPERVISE_ZERO = ("faults", "replays", "stalls", "trips")


def supervise_counts(node) -> dict:
    return {k: node.metrics.val(f"supervise.{k}") for k in SUPERVISE_ZERO}


def check_supervised(node, where: str) -> dict:
    """The node runs supervised and its supervisor noted no fault,
    replay, stall or trip; its journal is empty. Returns the counts."""
    sup = node.supervisor
    if sup is None:
        raise AssertionError(f"{where}: the node runs without its "
                             f"supervisor")
    got = supervise_counts(node)
    if any(got.values()) or sup.journal_depth():
        raise AssertionError(f"{where}: the supervisor noted {got}, "
                             f"journal depth {sup.journal_depth()}")
    return got


# iterations of each supervision hook timed by supervise_hook_cost
HOOK_ITERS = 20000


async def supervise_hook_cost(sup, batch) -> dict:
    """The host us a window that supervision adds to a fault-free window,
    hook by hook, timed on the live supervisor after the floods (every
    breaker closed, the stage histograms full): the journal's admit and
    settle, the batch tick's ``poll()``, two ``note_ok``, the two watchdog
    ``deadline()`` lookups, the ``allow_device()`` gate, and the watchdog
    await (``wait_for`` of a shielded future) over a plain await of the
    same finished future."""
    import asyncio
    loop = asyncio.get_running_loop()
    n = HOOK_ITERS

    def per(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    out = {
        "journal": per(lambda: sup.journal_settle(sup.journal_admit(batch))),
        "poll": per(sup.poll),
        "note_ok": per(lambda: (sup.note_ok("dispatch"),
                                sup.note_ok("materialize"))),
        "deadline": per(lambda: (sup.deadline("dispatch"),
                                 sup.deadline("materialize"))),
        "allow_device": per(sup.allow_device)}

    async def awaits(watched: bool) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            f = loop.create_future()
            f.set_result(None)
            if watched:
                await asyncio.wait_for(asyncio.shield(f), 10.0)
            else:
                await f
        return (time.perf_counter() - t0) / n * 1e6

    plain = await awaits(False)
    # two watched awaits a window: dispatch and materialize
    out["watchdog_awaits"] = 2 * (await awaits(True) - plain)
    out["total"] = sum(out.values())
    return {k: round(v, 3) for k, v in out.items()}


TRACE_COUNTERS = ("trace.spans", "trace.windows", "trace.dropped")


def trace_numbers(node, first_id: int, counters0: dict) -> dict:
    """The flight recorder over one flood: the windows minted in it
    (trace ids above `first_id`) that the ring still holds — their
    enqueue root span is in it: the ring drops oldest first — and the
    analyzer's dispatch↔materialize overlap, stage occupancy and bubbles
    by class over their spans, and the recorder's counters over the flood
    (`counters0`: their values before it). Every held device window must
    have its enqueue and deliver spans under its trace and the dispatch
    and materialize spans under its trace or, fused, under its lead's
    (the ``fused`` event names the lead)."""
    from emqx_tpu_torch.broker.trace import analyze_spans
    rec = node.flight_recorder
    spans = [sp for sp in rec.spans() if sp.trace_id > first_id]
    by: dict = {}
    for sp in spans:
        by.setdefault(sp.trace_id, []).append(sp)
    names = {t: {sp.name for sp in sps} for t, sps in by.items()}
    held = [t for t in by if "enqueue" in names[t]]
    lead = {sp.trace_id: sp.meta["lead"] for sp in spans
            if sp.name == "fused"}
    device, fused, bad = 0, 0, []
    for t in held:
        if not any(sp.name == "window" and sp.meta["path"] == "device"
                   for sp in by[t]):
            continue
        device += 1
        src = lead.get(t, t)
        fused += src != t
        if src not in names or "enqueue" not in names[src]:
            continue           # the lead's spans left the ring first
        if not ({"enqueue", "deliver"} <= names[t]
                and {"dispatch", "dispatch_cached"} & names[src]
                and "materialize" in names[src]):
            bad.append((t, sorted(names[t]), sorted(names[src])))
    if bad:
        raise AssertionError(f"{len(bad)} device windows lack their "
                             f"spans, e.g. {bad[:3]}")
    a = analyze_spans([sp for sp in spans if sp.trace_id in set(held)],
                      per_window=0)
    m = node.metrics
    return {"counters": {k.split(".")[1]: m.val(k) - counters0[k]
                         for k in TRACE_COUNTERS},
            "minted": len(by), "held": len(held), "device_windows": device,
            "fused_windows": fused, "overlap": a.get("overlap"),
            "stage_occupancy": a.get("stage_occupancy"),
            "bubbles": a.get("bubbles"), "ring": rec.state()}


def latency_numbers(node, f: dict) -> dict:
    """The latency observatory over one flood (reset before it): p50/p99
    of ingress→routed and ingress→delivered by (qos, path), the legs'
    means over every series, the SLO burn — and its routed samples must
    equal the flood's stamped PUBLISHes, split by QoS as the flood's mix
    (every 4th at QoS 1)."""
    obs = node.latency_observatory
    sec = obs.section()
    by_q = {0: 0, 1: 0}
    for key, row in sec["routed"].items():
        by_q[int(key[1])] += row["count"]
    want = {0: f["sent"] - f["q1_sent"], 1: f["q1_sent"]}
    if by_q != want:
        raise AssertionError(f"the observatory's routed samples by QoS "
                             f"{by_q} are not the flood's {want}")
    means = {}
    for leg in ("routed", "delivered"):
        hs = [h for k, h in node.metrics.histograms().items()
              if k.startswith(f"pipeline.latency.{leg}.") and h.count]
        n = sum(h.count for h in hs)
        means[leg] = sum(h.sum for h in hs) / n * 1e3 if n else None
    return {"routed": sec["routed"], "delivered": sec["delivered"],
            "mean_ms": means, "slo": sec["slo"]}


def hold_against_plain(eng, h, what: str) -> int:
    """A dispatched and materialized engine window held against the same
    window's program on the plain path (the plain shape match and scan)
    on the same device, from the cursors and the overlay version it
    started with: every plane of the route result, of the CSR readback,
    of the overlay planes and of their CSR, and the cursors, bit for bit.
    On the card the window was a CUDA graph replay. Returns max |diff|
    (0)."""
    import torch

    from emqx_tpu_torch.ops.scan import prefix_sum_ref
    from emqx_tpu_torch.ops.shapes import shape_match_ref
    if eng.device.type == "cuda":
        torch.cuda.synchronize()        # the engine stream's uploads
    ins = [torch.from_numpy(a).to(eng.device) for a in h.arrays]
    res, cp, dp, dcp = eng._unwrap(eng._program(
        h.built.backend, h.tables, h.delta.dev if h.delta is not None
        else None, h.cursors0, ins, h.strat, h.cls, match=shape_match_ref,
        scan=prefix_sum_ref))
    err = 0
    for got, want, fam in ((h.res, res, ""), (h.cres, cp, "compact "),
                           (h.dres, dp, "delta "),
                           (h.dcres, dcp, "delta compact ")):
        if (got is None) != (want is None):
            raise AssertionError(f"{what}: {fam}planes present on one "
                                 f"path only")
        if got is None:
            continue
        for name in want._fields:
            err = max(err, exact(getattr(got, name), getattr(want, name),
                                 f"{what} {fam}{name}"))
    return max(err, exact(eng._cursors, res.new_cursors[-1],
                          f"{what} cursors"))


def hold_window(eng, lives: list, what: str, want_plan: bool) -> int:
    """One engine window of `lives` (prepare_window → dispatch →
    materialize) held against the plain path (``hold_against_plain``).
    The window must take the shape-hash route window with a CSR readback
    (and the dedup plan when `want_plan`); on the card it must be a CUDA
    graph replay, its class captured first if the traffic has not warmed
    it. The window is abandoned afterwards (nothing is delivered).
    Returns max |diff| (0)."""
    import torch
    dev = eng.device
    h = eng.prepare_window(lives, gate_cold=False)
    if h is None or h.built.backend != "shapes" or h.pcap is None \
            or (want_plan and h.plan is None):
        raise AssertionError(f"{what}: the compared window did not take "
                             f"the shape-hash route window with a CSR "
                             f"readback" + (" and the dedup plan"
                                            if want_plan else ""))
    if dev.type == "cuda":
        Wp, Bp = h.enc[0].shape[:2]
        cls = (Wp, Bp, h.plan.Bm if h.plan is not None else None, None,
               h.pcap)
        if eng._graph_key(h.built, cls, eng._strategy()) not in eng._graphs:
            with torch.cuda.stream(eng._warm_stream):
                eng._warm_dispatch(h.built, eng._tables, eng._cursors, cls)
    eng.dispatch(h)
    eng.materialize(h)
    if dev.type == "cuda" and not h.graphed:
        raise AssertionError(f"{what}: the compared window was not a graph "
                             f"replay")
    err = hold_against_plain(eng, h, what)
    eng.abandon(h)
    return err


def e2e_window_check(node, ids: int, nums: int, seed: int, batches: int,
                     batch: int) -> int:
    """Engine windows of flood topics held against the plain path
    (``hold_window``): first a window of uniform topics (at phase 8's size
    the plain route window: too diverse to deduplicate), then one drawn
    from 512 of them (the dedup plan engages and the cached window runs).
    On the card both are CUDA graph replays, one after the other, so the
    second replays over the first's state. Returns max |diff| (0)."""
    from emqx_tpu_torch.broker.message import make
    r = np.random.RandomState(seed)
    hot = [(r.randint(0, ids), r.randint(0, nums)) for _ in range(512)]
    err = 0
    for rep in range(2):
        pick = (lambda: (r.randint(0, ids), r.randint(0, nums))) \
            if rep == 0 else (lambda: hot[r.randint(0, len(hot))])
        lives = [[make("cmp", 0, "device/d%d/x/n%d/t" % pick(), b"")
                  for _ in range(batch)] for _ in range(batches)]
        err = max(err, hold_window(node.device_engine, lives, "e2e window",
                                   rep == 1))
    return err


# phase 13b: one fault cycle in phase 8's flood. The materialize hang
# fires on the (a+1)-th readback, the three dispatch faults on the
# (b+1)-th to (b+3)-th dispatches, at the node's threshold (3). The
# 16,000-message flood dispatches ~16 windows: b = 8 leaves ~5 after the
# faults, so the rung is back at 0 before the last of them (with b = 10
# one window or none followed the recovery on one H100)
CHAOS_AFTER = (4, 8)
CHAOS_HANG_S = 1.0
# the chaos tuning in this flood: a breaker cycle short enough to recover
# inside it, and a fixed watchdog deadline (multiplier 0) under the hang
# but 20x the flood's readback p99 (~12 ms on one H100, PERF.md); a p99
# multiple would follow a loaded host's readbacks past the hang
CHAOS_TUNING = dict(cooldown_s=0.05, floor_s=0.25, mult=0.0)


class _RungLog:
    """Stands in for the supervisor's flight recorder during the chaos
    flood: notes the time of every trip and rung change (on the thread
    that made it) and passes the event on to the node's recorder."""

    def __init__(self, inner):
        self.inner, self.events = inner, []

    def event(self, trace_id, name, **kw):
        self.events.append((time.perf_counter(), name, kw.get("meta") or {}))
        return self.inner.event(trace_id, name, **kw) \
            if self.inner is not None else 0

    def trip_and_back(self) -> tuple:
        """(time of the first trip, time the ladder was next back at rung
        0), None where it did not happen."""
        t_trip = t_back = None
        for t, _name, meta in self.events:
            if meta.get("trip") and t_trip is None:
                t_trip = t
            elif t_trip is not None and not meta.get("trip") \
                    and meta.get("rung") == 0:
                t_back = t
                break
        return t_trip, t_back


async def _chaos_flood(node, subs, pubs, ids: int, nums: int, total: int,
                       seed: int) -> dict:
    """Phase 13b: one flood of phase 8's traffic at dispatch depth 1 with
    a ``materialize:hang`` clause and a ``dispatch:exception:count=3``
    clause armed to fire in the middle of it, at the node's breaker
    threshold (3) and the chaos tuning above. Every message must still be
    delivered once and in order (``_flood``); the hang must be caught as a
    stall and every faulted window replayed on the host, the three
    consecutive dispatch faults must trip the dispatch breaker (rung 2)
    and its probe must bring the ladder back to rung 0; the first window
    dispatched after that is held against the plain path, bit for bit
    (a held copy of its messages, run by the consumer once the window's
    stages are through: the hold blocks the loop and takes the device
    lock, so run while a window's stage is awaited it would pass that
    stage's 0.25 s watchdog and read as a real stall). Depth 1:
    at depth 2 a healthy window settles (its ``note_ok`` resets the
    breaker's consecutive count) between the faulted ones, as in the
    reference, and three faults need not trip. Afterwards the window
    journal and the HBM ledger's pins are 0, once the hung readback's
    thread has left its window. Returns the flood's numbers."""
    import asyncio

    from emqx_tpu_torch.broker.supervise import FaultInjector, parse_faults
    sup, eng, pb, m = node.supervisor, node.device_engine, \
        node.publish_batcher, node.metrics
    saved = ({p: (b.base_cooldown_s, b.cooldown_s)
              for p, b in sup.breakers.items()},
             sup.wd_floor_s, sup.wd_mult, sup.recorder, pb.dispatch_depth)
    for br in sup.breakers.values():
        br.base_cooldown_s = br.cooldown_s = CHAOS_TUNING["cooldown_s"]
    sup.wd_floor_s, sup.wd_mult = CHAOS_TUNING["floor_s"], \
        CHAOS_TUNING["mult"]
    pb.dispatch_depth = 1
    log_ = sup.recorder = _RungLog(saved[3])
    counts0 = supervise_counts(node)
    held = {"err": None, "batches": None, "handle": None}
    replayed = {"us": 0, "msgs": 0, "windows": 0}
    real_dispatch, real_stages, real_host = \
        pb._dispatch, pb._stages, pb._complete_host

    def dispatch(loop, handle):
        if held["handle"] is None and log_.trip_and_back()[1] is not None \
                and all(f.fired >= f.count for f in sup.injector.faults):
            held["handle"] = handle
        return real_dispatch(loop, handle)

    async def stages(entry, loop):
        ok = await real_stages(entry, loop)
        # at depth 1 the consumer awaits one window's stages at a time:
        # once they are through none is awaited, so the hold's time
        # counts against no watchdog
        if held["err"] is None and entry["handle"] is held["handle"]:
            held["batches"] = m.val("routing.device.batches")
            held["err"] = hold_window(
                eng, [msgs for msgs, _t in entry["handle"].subs],
                "phase 13b: the first window after recovery", False)
        return ok

    async def complete_host(entry, routed=None):
        if routed is not None or not entry.get("replayed"):
            return await real_host(entry, routed)
        us0, n0 = m.val("routing.host.route_us"), \
            m.val("routing.host.messages")
        await real_host(entry, routed)
        replayed["us"] += m.val("routing.host.route_us") - us0
        replayed["msgs"] += m.val("routing.host.messages") - n0
        replayed["windows"] += 1

    a, b = CHAOS_AFTER
    spec = (f"materialize:hang:after={a}:count=1:hang_s={CHAOS_HANG_S},"
            f"dispatch:exception:after={b}:count=3")
    pb._dispatch, pb._stages, pb._complete_host = \
        dispatch, stages, complete_host
    sup.injector = FaultInjector(parse_faults(spec))
    try:
        f = await _flood(node, subs, pubs, ids, nums, total, seed,
                         replays=True)
        # the hung readback's thread leaves its window, then releases it
        deadline = time.time() + CHAOS_HANG_S + 5
        while eng._outstanding and time.time() < deadline:
            await asyncio.sleep(0.01)
        fired = sup.injector.state()
    finally:
        sup.injector = FaultInjector()
        pb._dispatch, pb._stages, pb._complete_host = \
            real_dispatch, real_stages, real_host
        for p, (base, cur) in saved[0].items():
            sup.breakers[p].base_cooldown_s = base
            sup.breakers[p].cooldown_s = cur
        sup.wd_floor_s, sup.wd_mult, sup.recorder, pb.dispatch_depth = \
            saved[1:]
    t_trip, t_back = log_.trip_and_back()
    got = {k: v - counts0[k] for k, v in supervise_counts(node).items()}
    led = node.hbm_ledger
    pins = led.pin_state()["outstanding"] if led is not None else 0
    out = {"spec": spec, "fired": fired, "supervise": got,
           "trip_to_rung0_s": None if t_back is None else t_back - t_trip,
           "rung": sup.rung(),
           "breakers": {p: br.state for p, br in sup.breakers.items()
                        if br.state != "closed"},
           "journal_depth": sup.journal_depth(), "ledger_pins": pins,
           "replayed_windows": replayed["windows"],
           "replayed_msgs": replayed["msgs"],
           "replay_host_us_per_msg":
               replayed["us"] / max(1, replayed["msgs"]),
           "held_err": held["err"],
           "probe_launches": dict(eng.probe_launches),
           "batches_after_recovery":
               None if held["batches"] is None
               else m.val("routing.device.batches") - held["batches"],
           "rung_events": [(round(t - (t_trip or t), 6), n, meta)
                           for t, n, meta in log_.events],
           "flood": {k: f[k] for k in ("sent", "delivered", "per_sec",
                                       "device_routed", "batches",
                                       "windows", "lat_p99_ms")}}
    bad = []
    if any(c["fired"] < c["count"] for c in fired):
        bad.append(f"a clause did not fire: {fired}")
    if got["stalls"] < 1:
        bad.append("the readback hang was not caught as a stall")
    if got["replays"] < 4 or replayed["windows"] < got["replays"]:
        bad.append(f"{got['replays']} replays ({replayed['windows']} "
                   f"windows replayed on the host) for 4 faulted windows")
    if got["trips"] < 1 or t_trip is None:
        bad.append("three consecutive dispatch faults did not trip")
    if t_back is None or out["rung"] != 0 or out["breakers"]:
        bad.append(f"not back at rung 0: rung {out['rung']}, open "
                   f"{out['breakers']}")
    if out["journal_depth"] or pins:
        bad.append(f"journal depth {out['journal_depth']}, ledger pins "
                   f"{pins} after the flood")
    if held["err"] is None:
        bad.append("no window dispatched after the recovery")
    elif held["err"] or not out["batches_after_recovery"]:
        bad.append(f"after the recovery: held window err {held['err']}, "
                   f"{out['batches_after_recovery']} device batches")
    if bad:
        raise AssertionError("phase 13b: " + "; ".join(bad)
                             + f" ({json.dumps(out, default=str)})")
    return out


def e2e_drive(dev, n_filters: int = E2E_FILTERS,
              n_sub: int = E2E_SUB_CONNS, n_pub: int = E2E_PUB_CONNS,
              total: int = E2E_MSGS, runs=E2E_RUNS,
              min_device_share: float = E2E_MIN_DEVICE_SHARE,
              window=(8, 1024), seed: int = SEED, report=None,
              pin_device: bool = False, profile: bool = False,
              chaos: bool = False, node_conf=None) -> dict:
    """Phase 8: the port's Node (the reference's defaults, delivery lanes
    and HBM ledger included) with its Listener on 127.0.0.1, the bench.py
    e2e population subscribed over TCP, the bench warm-up, then one flood
    per (label, dispatch depth, lanes on) of `runs` on the same node (a
    lanes-off flood detaches the node's lane pool for its run), and one
    engine window held against the plain path after the first flood.
    ``report(label, flood)`` sees each flood's numbers before its checks;
    ``pin_device`` pins the batcher's device/host chooser to the device
    (for a rehearsal on the CPU, where the host path wins; never in the
    measured run). With ``profile`` one more flood at the first run's
    depth, lanes on, runs under torch.profiler for the card's busy time
    (not one of the measured floods). A run whose fifth field is False
    floods with the node's supervisor detached (``_supervision``); every
    supervised flood must leave the supervisor's fault, replay, stall and
    trip counts at 0. With ``chaos``, one more flood runs with faults
    armed in the middle of it (``_chaos_flood``, phase 13b). Raises on any
    failed check. ``node_conf`` adds ``broker`` keys to the node's
    configuration (a rehearsal's smaller batches)."""
    import asyncio

    async def run():
        from emqx_tpu_torch.broker.connection import Listener
        from emqx_tpu_torch.broker.node import Node
        from emqx_tpu_torch.client import Client
        import torch
        alloc0 = torch.cuda.memory_allocated(dev) \
            if dev.type == "cuda" else None
        node = Node({"broker": dict(node_conf or {},
                                    dispatch_depth=runs[0][1])}, device=dev)
        lanes = node.deliver_lanes
        sup = node.supervisor
        _time_dispatches(node.device_engine)
        if pin_device:
            node.publish_batcher._device_worth_it = lambda: True
        lst = Listener(node, bind="127.0.0.1", port=0)
        await lst.start()
        clients = []
        try:
            t0 = time.time()
            subs, ids, nums, n_shared, n_entries = \
                await _subscribe_population(lst.port, n_filters, n_sub)
            clients += subs
            t_sub = time.time() - t0
            pubs = []
            for c in range(n_pub):
                cl = Client(port=lst.port, clientid=f"epub{c}")
                await cl.connect()
                pubs.append(cl)
            clients += pubs
            t0 = time.time()
            await _warm_up(node, pubs[0], subs, nums)
            t_warm = time.time() - t0
            out = {"filters": ids * nums, "shared_filters": n_shared,
                   "columnar_ingress": node.columnar_ingress,
                   "subscriptions": n_entries, "subscribe_s": t_sub,
                   "warm_up_s": t_warm,
                   "backend": node.device_engine._built.backend,
                   "floods": {}}
            # the routing state is long-lived (~1M objects at 100k
            # subscriptions): frozen out of the cyclic collector, no full
            # collection rescans it in the middle of a flood
            gc.collect()
            gc.freeze()
            rec, obs = node.flight_recorder, node.latency_observatory
            objective = obs.objective_ms
            for k, (label, depth, lanes_on, layers, supervised) \
                    in enumerate(runs):
                # the batcher's consumer reads the depth when it starts,
                # and it parks between floods (the lanes are drained by
                # then: every future resolved)
                node.publish_batcher.dispatch_depth = depth
                node.deliver_lanes = lanes if lanes_on else None
                _supervision(node, sup if supervised else None, lanes)
                sup0 = supervise_counts(node)
                traced = layers in ("on", "quiet")
                _observability(node, rec if traced else None,
                               obs if layers != "off" else None)
                _objective(obs, 1e9 if layers == "quiet" else objective)
                if layers != "off":
                    obs.reset()
                first_id = node.publish_batcher.last_trace
                tr0 = {c: node.metrics.val(c) for c in TRACE_COUNTERS}
                tele0 = tele_state(node)
                pinned0 = _host_allocs(dev)
                f = await _flood(node, subs, pubs, ids, nums, total,
                                 seed + 100 * k)
                f["lanes_on"] = lanes_on
                f["supervised"] = supervised
                f["supervise"] = {k: v - sup0[k] for k, v in
                                  supervise_counts(node).items()}
                if any(f["supervise"].values()):
                    raise AssertionError(f"{label}: the supervisor noted "
                                         f"{f['supervise']}")
                f["traced"] = traced
                f["layers"] = layers
                f["trace"] = trace_numbers(node, first_id, tr0) \
                    if traced else None
                f["latency"] = latency_numbers(node, f) \
                    if layers != "off" else None
                if not traced and node.publish_batcher.last_trace \
                        != first_id:
                    raise AssertionError(f"{label}: a window was traced "
                                         f"with the recorder detached")
                if layers == "quiet" and f["latency"]["slo"]["breaches"]:
                    raise AssertionError(f"{label}: a message breached the "
                                         f"raised objective")
                f["telemetry"] = tele_delta(node, tele0)
                st = f["telemetry"]["stages"]
                f["lane_us_per_msg"] = sum(
                    v["sum_ms"] for n, v in st.items()
                    if n.startswith("deliver_lane")) * 1e3 / f["sent"]
                f["lane_items"] = sum(v["count"] for n, v in st.items()
                                      if n.startswith("deliver_lane"))
                if pinned0 is not None:
                    f["pinned_host_allocs"] = _host_allocs(dev) - pinned0
                if report is not None:
                    report(label, f)
                if f["batches"] <= 0:
                    raise AssertionError(f"{label}: no device batch "
                                         f"during the flood")
                share = f["device_routed"] / f["sent"]
                if share < min_device_share:
                    raise AssertionError(
                        f"{label}: {share:.3f} of the flood was "
                        f"routed by the device engine (< "
                        f"{min_device_share})")
                if lanes_on and (f["lane_rows"] <= 0
                                 or f["lane_plans"] <= 0):
                    raise AssertionError(
                        f"{label}: the delivery lanes did not engage "
                        f"({f['lane_rows']} rows, {f['lane_plans']} plans)")
                if not lanes_on and f["lane_rows"]:
                    raise AssertionError(f"{label}: {f['lane_rows']} rows "
                                         f"went to detached lanes")
                if dev.type == "cuda" and (f["launches"]["shape_match"] == 0
                                           or f["launches"]["prefix_sum"]
                                           == 0):
                    raise AssertionError(f"{label}: a kernel was not "
                                         f"launched: {f['launches']}")
                if dev.type == "cuda" and out["backend"] == "shapes" \
                        and f["launches"]["shape_match"] != f["windows"]:
                    # one fold+probe per shape-hash window; warm-ups are
                    # recorded, not counted
                    raise AssertionError(
                        f"{label}: {f['launches']['shape_match']} "
                        f"shape_match launches for {f['windows']} windows")
                out["floods"][label] = f
                if k == 0:
                    out["window_err"] = e2e_window_check(
                        node, ids, nums, seed + 1, *window)
            node.deliver_lanes = lanes
            _supervision(node, sup, lanes)
            out["supervise"] = check_supervised(node, "phase 8")
            out["supervise_section"] = \
                node.pipeline_telemetry.snapshot()["supervise"]
            out["supervise_cost_us"] = await supervise_hook_cost(
                sup, [(None, None)] * 64)
            _observability(node, rec, obs)
            _objective(obs, objective)
            out["ledger"] = ledger_line(node, alloc0) \
                if node.hbm_ledger is not None else None
            frac = (out["ledger"] or {}).get("accounted_fraction")
            if frac is not None and frac > 1.0:
                raise AssertionError(
                    f"the HBM ledger accounts {frac} of the card's "
                    f"allocated bytes (> 1: aliases counted twice)")
            # the floods' uniform traffic leaves the dedup plan idle (a
            # fused window holds more unique topics than Bp, a single
            # batch's miss class is its batch class); the checked window
            # drawn from 512 topics runs the cached program
            out["cached_windows"] = node.metrics.val(
                "routing.device.cached_windows")
            if out["cached_windows"] <= 0:
                raise AssertionError("phase 8 ran no cached window")
            if profile:
                # a recorder whose ring holds the whole flood: a breach
                # event a message, the sampled message spans and ~20
                # spans a window come to about `total` spans
                from emqx_tpu_torch.broker.trace import FlightRecorder
                node.publish_batcher.dispatch_depth = runs[0][1]
                _observability(node, FlightRecorder(
                    node.metrics, cap=4 * total, sample=rec.sample), obs)
                try:
                    out["profiled"] = await _profiled_flood(
                        node, subs, pubs, ids, nums, total, seed + 1000)
                finally:
                    _observability(node, rec, obs)
                check_supervised(node, "phase 8's profiled flood")
            if chaos:
                node.publish_batcher.dispatch_depth = runs[0][1]
                out["chaos"] = await _chaos_flood(
                    node, subs, pubs, ids, nums, total, seed + 2000)
            out["stats"] = node.device_engine.stats()
            out["ingress_lanes"] = {
                "lanes": node.ingress_lanes,
                "servers": len(lst._lane_servers),
                "accepted": {k: v for k, v in node.metrics.all().items()
                             if k.startswith("pipeline.ingress.lane")}}
            return out
        finally:
            gc.unfreeze()
            for cl in clients:
                await cl.disconnect()
            await lst.stop()
            await node.publish_batcher.stop()
            node.publish_batcher.close()

    return asyncio.run(run())


def e2e_phase(dev, card: str) -> dict:
    """Phase 8 at bench.py's e2e size on the card; prints its lines."""
    def report(label, f):
        row = {k: f[k] for k in ("sent", "delivered", "per_sec",
                                 "device_routed", "batches",
                                 "device_bypassed")}
        samples = {k: {q: round(v, 2) for q, v in d.items()}
                   for k, d in f["samples_us"].items()}
        wins = {k: {q: round(v, 2) for q, v in d.items()}
                for k, d in f["window_us"].items()}
        stage_us = {k: round(v, 2) for k, v in f["device_us_per_msg"].items()}
        disp = dict(f["dispatch_ms"], sum=round(f["dispatch_ms"]["sum"], 3))
        depth = f"{label} (lanes {'on' if f['lanes_on'] else 'off'}, " \
            f"recorder and observatory {f['layers']}, supervisor " \
            f"{'on' if f['supervised'] else 'detached'})"
        log(f"phase 8 {depth}: {json.dumps(row)}")
        if f["trace"] is not None:
            tr, lat = f["trace"], f["latency"]
            bub = tr["bubbles"] or {}
            occ = {k: v["total_s"] for k, v in
                   (tr["stage_occupancy"] or {}).items()}
            log(f"phase 8 {depth}: trace {json.dumps(tr['counters'])} "
                f"over the flood, ring {json.dumps(tr['ring'])}; "
                f"{tr['minted']} windows minted, {tr['held']} held in the "
                f"ring ({tr['device_windows']} device windows, "
                f"{tr['fused_windows']} fused followers), each with its "
                f"enqueue, dispatch, materialize and deliver spans; "
                f"dispatch<->materialize overlap "
                f"{json.dumps(tr['overlap'])}; bubbles (s) "
                f"{json.dumps(bub)}; stage seconds {json.dumps(occ)} over "
                f"the flood's {f['wall_s']:.3f} s")
            legs = {leg: {k: [v["p50_ms"], v["p99_ms"], v["count"]]
                          for k, v in lat[leg].items()}
                    for leg in ("routed", "delivered")}
            log(f"phase 8 {depth}: latency observatory (p50 ms, p99 ms, "
                f"samples) by qos.path {json.dumps(legs)}; means (ms) "
                f"{json.dumps(lat['mean_ms'])}; SLO "
                f"{json.dumps(lat['slo'])}; routed samples = the "
                f"{f['sent']} stamped PUBLISHes ({f['q1_sent']} at QoS 1)")
        log(f"phase 8 {depth}: {f['per_sec']} msgs/s, client "
            f"PUBLISH->deliver p50 {f['lat_p50_ms']:.3f} ms p99 "
            f"{f['lat_p99_ms']:.3f} ms, "
            f"{f['device_routed'] / f['sent']:.3f} on the device; consume "
            f"(plan construction with the lanes) "
            f"{f['device_us_per_msg']['consume']:.2f} us/msg, dispatch "
            f"{f['device_us_per_msg']['dispatch']:.2f} us/msg, the lanes' "
            f"own delivery {f['lane_us_per_msg']:.2f} us/msg over "
            f"{f['lane_items']} lane items; pipeline.deliver.rows "
            f"{f['lane_rows']}, plans {f['lane_plans']}; pinned host blocks "
            f"allocated during the flood "
            f"{f.get('pinned_host_allocs', 'not counted')}")
        if label == E2E_RUNS[0][0]:
            log(f"phase 8 {depth} telemetry over the flood: "
                f"{json.dumps(f['telemetry'])}")
        log(f"phase 8 {depth}: batcher route latency "
            f"{json.dumps(f['route_lat'])}; "
            f"{f['windows']} device windows ({f['compact_overflow']} read "
            f"dense: CSR payload overflow); launches {f['launches']}; "
            f"chooser: device {f['dev_msg_us']:.2f} us per message, host "
            f"{f['host_msg_us']:.2f} us per message, its samples (us per "
            f"message) {json.dumps(samples)}, the device windows' own "
            f"(small: under {f['small_window']} messages) "
            f"{json.dumps(wins)}; us per message: device "
            f"path {json.dumps(stage_us)}, host path "
            f"{f['host_us_per_msg']:.2f}; dispatches {json.dumps(disp)} (ms: "
            f"the slowest as total, staging + replay, readback staging)")
        log(f"phase 8 {depth}: routing layers {json.dumps(f['layers'])}")
        ing = f["ingress"]
        log(f"phase 8 {depth}: columnar ingress {json.dumps(ing)}: "
            f"{ing['burst_share']} of the PUBLISHes came in bursts, "
            f"{ing['rows_per_burst']} rows per burst; prepare "
            f"{f['device_us_per_msg']['prepare']:.2f} us/msg")

    r = e2e_drive(dev, runs=E2E_RUNS[:1] + E2E_SUPERVISE_RUNS
                  + E2E_RUNS[1:], report=report, profile=True, chaos=True)
    log(f"phase 8: {r['filters']} filters ({r['shared_filters']} in "
        f"2-member $share groups) subscribed as {r['subscriptions']} "
        f"subscriptions over {E2E_SUB_CONNS} connections in "
        f"{r['subscribe_s']:.1f} s; warm-up {r['warm_up_s']:.1f} s; "
        f"backend {r['backend']}")
    log("phase 8: two engine windows (prepare_window/dispatch/materialize, "
        "CUDA graph replays: the plain window and the dedup-cached window) "
        "== plain path: every plane, CSR payload and cursors (exact)")
    log(f"phase 8: columnar_ingress {r['columnar_ingress']}, acceptor "
        f"lanes {json.dumps(r['ingress_lanes'])}")
    log(f"phase 8: {r['cached_windows']} cached windows in all; engine "
        f"stats {json.dumps(r['stats'])}")
    log(f"phase 8: subscription_covering "
        f"{r['stats']['subscription_covering']}, cover "
        f"{json.dumps(r['stats']['cover'])}, detection "
        f"{r['stats']['cover_detect_s']} s")
    fl = r["floods"]
    on, off = fl["d2"], fl["d2-inline"]
    log(f"phase 8 lanes on vs off at depth 2: {on['per_sec']} vs "
        f"{off['per_sec']} msgs/s ({on['per_sec'] / off['per_sec']:.3f}x), "
        f"p99 {on['lat_p99_ms']:.3f} vs {off['lat_p99_ms']:.3f} ms, "
        f"consume {on['device_us_per_msg']['consume']:.2f} vs "
        f"{off['device_us_per_msg']['consume']:.2f} us/msg, dispatch "
        f"{on['device_us_per_msg']['dispatch']:.2f} vs "
        f"{off['device_us_per_msg']['dispatch']:.2f} us/msg")
    log(f"phase 8 recorder and observatory on / off at depth 2, lanes on: "
        f"{fl['d2']['per_sec']} / {fl['d2-untraced']['per_sec']} msgs/s "
        f"(one flood each, no ratio claimed)")
    rounds = E2E_RUNS[:1] + E2E_SUPERVISE_RUNS
    sup_on = [fl[run[0]]["per_sec"] for run in rounds if run[4]]
    sup_off = [fl[run[0]]["per_sec"] for run in rounds if not run[4]]
    r["supervise_rounds"] = {
        "supervised": sup_on, "unsupervised": sup_off,
        "ratio_of_medians": float(np.median(sup_on) / np.median(sup_off))}
    log(f"phase 8 supervised / unsupervised at depth 2, lanes on, "
        f"{len(sup_off)} rounds in rotated order: msgs/s "
        f"{sup_on} / {sup_off}, medians {int(np.median(sup_on))} / "
        f"{int(np.median(sup_off))} "
        f"({r['supervise_rounds']['ratio_of_medians']:.3f}x)")
    log(f"phase 8: the supervisor noted {json.dumps(r['supervise'])} over "
        f"the phase's floods; live supervise section "
        f"{json.dumps(r['supervise_section'])}")
    cost, d2 = r["supervise_cost_us"], fl["d2"]
    win_us = d2["wall_s"] / max(d2["windows"], 1) * 1e6
    r["supervise_cost_share"] = cost["total"] / win_us
    log(f"phase 8 supervision hooks, host us a fault-free window "
        f"({HOOK_ITERS} calls each on the live supervisor): "
        f"{json.dumps(cost)}; {cost['total']:.2f} us against the d2 "
        f"flood's {win_us:.1f} us of wall time a window "
        f"({r['supervise_cost_share']:.5f} of it)")
    c = r["chaos"]
    log(f"phase 13b (phase 8's node and flood at depth 1, threshold 3, "
        f"{json.dumps(CHAOS_TUNING)}): {c['spec']}; every message "
        f"delivered once and in order {json.dumps(c['flood'])}; "
        f"supervise {json.dumps(c['supervise'])}; trip -> rung 0 in "
        f"{c['trip_to_rung0_s']:.4f} s; {c['replayed_windows']} windows "
        f"({c['replayed_msgs']} messages) replayed on the host at "
        f"{c['replay_host_us_per_msg']:.2f} host us a message; the first "
        f"window after recovery == plain path (max |diff| "
        f"{c['held_err']}), {c['batches_after_recovery']} device batches "
        f"after it; journal {c['journal_depth']}, ledger pins "
        f"{c['ledger_pins']}; rung events (s from the trip, name, meta) "
        f"{json.dumps(c['rung_events'])}")
    led = r["ledger"]
    log(f"phase 8 HBM ledger: live {led['live_bytes']} bytes by category "
        f"{json.dumps(led['by_category'])}, peak {led['peak_bytes']}, "
        f"pipeline_buffers by graph class "
        f"{json.dumps(led['pipeline_buffers_by_class'])}, accounted "
        f"{led['accounted_fraction']} of torch.cuda.memory_allocated() "
        f"{led['memory_allocated']} ({led['accounted_of_phase']} of the "
        f"{led['memory_allocated'] - led['allocated_before']} bytes "
        f"allocated since this phase began); pins "
        f"{json.dumps(led['pins'])}")
    p = r["profiled"]
    log(f"phase 8 profiled flood ({E2E_RUNS[0][0]}, lanes on): device busy "
        f"{p['device_busy_s'] * 1e3:.1f} ms of {p['wall_s']:.2f} s, idle "
        f"share {p['idle_share']:.4f}, {p['windows']} windows, "
        f"{p['per_sec']} msgs/s under the profiler; largest device "
        f"entries (name, ms, count): {p['top']}; {p['route_steps']} "
        f"route_step ranges naming {p['route_step_traces']} window traces "
        f"of the {p['dispatched_traces']} the ring holds a dispatch span "
        f"under, every one among them; the flood's ring "
        f"{json.dumps(p['ring'])} (nothing overwritten)")
    for depth, f in r["floods"].items():
        log(f"phase 8 {depth}: every message delivered once "
            f"to a connection holding its filter; per-publisher order held "
            f"at every subscriber for plain and for shared deliveries"
            f"{' (per QoS: a session queued)' if f['order_per_qos'] else ''}"
            f"; {f['device_routed'] / f['sent']:.3f} of it routed by the "
            f"device engine")
    log(card)
    return r


def trace_cost_runs(rounds: int = TRACE_ROUNDS) -> tuple:
    """The ``--trace-cost`` floods: each of TRACE_LAYERS at depth 2 with
    the lanes, in `rounds` rounds, round r's order rotated by r (no
    setting always runs first, after the warm-up)."""
    out = []
    for r in range(rounds):
        k = r % len(TRACE_LAYERS)
        for layers in TRACE_LAYERS[k:] + TRACE_LAYERS[:k]:
            out.append((f"d2-{layers}-{r + 1}", 2, True, layers, True))
    return tuple(out)


def trace_cost(dev, rounds: int = TRACE_ROUNDS, **kw) -> dict:
    """The observability layers' cost on phase 8's flood: e2e_drive (its
    checks included) over trace_cost_runs on one node; for each layer
    setting, in run order, each flood's msgs/s, the device path's host µs
    a message by stage (readback: materialize's host part on the card),
    the lanes' µs a message and the recorder's spans."""
    r = e2e_drive(dev, runs=trace_cost_runs(rounds), **kw)
    by: dict = {}
    for label, f in r["floods"].items():
        row = by.setdefault(f["layers"], {"labels": [], "per_sec": [],
                                          "stage_us": [], "lane_us": [],
                                          "spans": []})
        row["labels"].append(label)
        row["per_sec"].append(f["per_sec"])
        row["stage_us"].append({k: round(v, 2) for k, v in
                                f["device_us_per_msg"].items()})
        row["lane_us"].append(round(f["lane_us_per_msg"], 2))
        row["spans"].append(f["trace"]["counters"]["spans"]
                            if f["trace"] is not None else 0)
    return by


def trace_cost_main() -> int:
    """``--trace-cost``: trace_cost at phase 8's size on the card; a line
    for each layer setting, then one JSON line of the results."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from emqx_tpu_torch.ops.build import build
    build()
    card = card_line()
    log(card)
    by = trace_cost(torch.device("cuda"))
    for layers, row in by.items():
        per = row["per_sec"]
        log(f"trace cost {layers}: msgs/s {per} (min {min(per)}, median "
            f"{int(np.median(per))}, max {max(per)}); readback us/msg "
            f"{[s['readback'] for s in row['stage_us']]}; lanes us/msg "
            f"{row['lane_us']}; spans {row['spans']}; floods "
            f"{row['labels']}")
    log(json.dumps(by))
    log(card)
    return 0


# ---- phase 9: the reference's default routing layers ----------------------

L_W, L_B = 8, 1024           # the served fused class (8, 1024)
L_WINDOWS = 8                # windows per pass (48 before phase 18, 24
                             # before phase 20, 16 before QUIC)
L_PASSES = 2                 # untimed passes before the timed one: 1
                             # (2 before QUIC)
L_HOT = 16                   # tools/skew_bench.py: 90% on 16 hot topics
L_HOT_SHARE = 0.9
L_WARM_WINDOWS = 24          # cap on the warm-up windows
C_BATCH = 512                # tools/churn_bench.py: route_batch of 512
C_BATCHES = 8                # batches per pass (48 before phase 18, 24
                             # before phase 20, 16 before QUIC)
C_FRESH = 4                  # fresh subscriptions per batch
C_LIVE = 64                  # live fresh filters at most
C_SHARE = 0.25               # lanes to the fresh filters' topics
LAYERS_OFF = {"topic_dedup": False, "match_cache_size": 0,
              "delta_overlay": False, "subscription_covering": False}


class _Sink:
    """A session stand-in: every delivery (payload, filter) in order."""

    __slots__ = ("got",)

    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((msg.payload, topic_filter))
        return True


def _population(ids: int, nums: int, n_sub: int):
    """bench.py:1212-1243's population in the order phase 8's connections
    subscribe it: (session, filter, QoS, second membership) for n_sub
    sessions, each with its plain filters (QoS 0) and shared groups (QoS
    1, in 2-member $share/bg groups), plus the second membership of the
    previous session's groups."""
    for c in range(n_sub):
        for cc, second in ((c, False), ((c - 1) % n_sub, True)):
            for i in range(cc, ids, n_sub):
                for n in range(nums):
                    f = f"device/d{i}/+/n{n}/#"
                    if e2e_shared(i, n, nums):
                        yield c, f"$share/bg/{f}", 1, second
                    elif not second:
                        yield c, f, 0, second


def _populate(node, ids: int, nums: int, n_sub: int) -> list:
    """``_population`` through broker.subscribe, one sink a session."""
    b = node.broker
    sinks = [_Sink() for _ in range(n_sub)]
    sids = [b.register(s, f"esub{c}") for c, s in enumerate(sinks)]
    for c, f, qos, _second in _population(ids, nums, n_sub):
        b.subscribe(sids[c], f, {"qos": qos})
    return sinks


def _take(sinks) -> list:
    """Every session's deliveries since the last call."""
    out = [s.got for s in sinks]
    for s in sinks:
        s.got = []
    return out


def _skew_windows(ids: int, nums: int, seed: int) -> list:
    """One pass of tools/skew_bench.py:82-105's traffic: L_WINDOWS windows
    of L_W x L_B messages, 90% of the lanes on 16 hot topics, the rest
    uniform over the population's topics."""
    from emqx_tpu_torch.broker.message import make
    r = np.random.RandomState(seed)
    hot = [(int(r.randint(0, ids)), int(r.randint(0, nums)))
           for _ in range(L_HOT)]
    n = L_WINDOWS * L_W * L_B
    is_hot = r.rand(n) < L_HOT_SHARE
    hi = r.randint(0, L_HOT, n)
    ui, un = r.randint(0, ids, n), r.randint(0, nums, n)
    msgs = [make("skew", 0, "device/d%d/x/n%d/t" % (hot[hi[k]] if is_hot[k]
                                                    else (ui[k], un[k])),
                 b"%d" % k) for k in range(n)]
    return [[msgs[(w * L_W + k) * L_B:(w * L_W + k + 1) * L_B]
             for k in range(L_W)] for w in range(L_WINDOWS)]


async def _skew_pass(node, sinks, windows, hold: bool = False) -> dict:
    """One pass of windows through prepare_window → dispatch →
    materialize → finish_sub, two windows in flight (window k+1 is
    dispatched before window k is read back). Returns the per-window
    counts and deliveries, latencies, classes and the counter deltas;
    with `hold`, the last window is held against the plain path."""
    import asyncio
    import collections
    eng = node.device_engine
    m = node.metrics
    keys = ("routing.device.messages", *STAGE_US, *LAYER_COUNTERS)
    before = {k: m.val(k) for k in keys}
    out = {"counts": [], "got": [], "lat": [], "bm": collections.Counter(),
           "graphed": 0, "err": 0}
    prev = None

    def finish(h, ts):
        eng.materialize(h)
        if hold and h is last:
            out["err"] = hold_against_plain(eng, h, "layers window")
        # inline consume (the lanes would deliver after this returns;
        # phase 8 drives them): the pass reads the deliveries right away
        out["counts"].append([c for k in range(len(h.subs))
                              for c in eng.finish_sub(h, k, defer=False)])
        out["lat"].append(time.perf_counter() - ts)
        out["got"].append(_take(sinks))
        out["bm"][str(h.cls[2])] += 1
        out["graphed"] += h.graphed

    last = None
    t0 = time.perf_counter()
    for lives in windows:
        ts = time.perf_counter()
        h = eng.prepare_window(lives)
        if h is None:
            raise AssertionError("the layers window found no snapshot")
        eng.dispatch(h)
        last = h
        if prev is not None:
            finish(*prev)
        prev = (h, ts)
        await asyncio.sleep(0)      # the background warm's turn
    finish(*prev)
    out["wall_s"] = time.perf_counter() - t0
    out["delta"] = {k: m.val(k) - v for k, v in before.items()}
    return out


async def _settle_warm(eng) -> None:
    """Wait for the engine's background class warm, if one runs."""
    import asyncio
    while eng._fuse_warm_task is not None:
        await asyncio.sleep(0.01)


async def _warm_skew(nodes: dict, ids: int, nums: int, seed: int) -> int:
    """Warm-up, the same windows on A, B and the host path (so their
    shared-group cursors stay in step): the standard classes captured,
    then windows of the skew traffic until one passes on both engines
    with no cold class and no eager dispatch (every class it wanted
    captured). Returns the windows it took."""
    for k in "AB":
        nodes[k].device_engine._kick_class_warm()
        await _settle_warm(nodes[k].device_engine)
    windows = _skew_windows(ids, nums, seed)

    def cold():
        return [nodes[k].metrics.val(f"routing.device.{c}") for k in "AB"
                for c in ("cold_cached_class", "cold_compact_class",
                          "eager_windows")]

    k = 0
    while k < L_WARM_WINDOWS:
        before = cold()
        one = windows[k % L_WINDOWS:][:1]
        for name in "AB":
            await _skew_pass(nodes[name], nodes[name].sinks, one)
            await _settle_warm(nodes[name].device_engine)
        _host_counts(nodes["H"], one)
        k += 1
        if k >= 3 and cold() == before:
            break
    for node in nodes.values():
        _take(node.sinks)
    return k


def _host_counts(node, windows) -> list:
    """The host path's delivery count per message (router.match +
    broker._route), window by window."""
    b, r = node.broker, node.router
    return [[b._route(msg, r.match(msg.topic)) for sub in lives
             for msg in sub] for lives in windows]


def _summary(name: str, p: dict, n_msgs: int) -> dict:
    lat = np.array(p["lat"]) * 1e3
    d = p["delta"]
    per = max(1, d["routing.device.messages"])
    return {"node": name, "topic_matches_per_s": n_msgs / p["wall_s"],
            "window_p50_ms": float(np.percentile(lat, 50)),
            "window_p99_ms": float(np.percentile(lat, 99)),
            "us_per_msg": stage_us(d),
            "graphed_windows": p["graphed"], "windows": len(p["lat"]),
            "bm": dict(p["bm"]), "layers": layer_numbers(d)}


async def _skew_cell(nodes: dict, ids: int, nums: int) -> dict:
    """9a: the skew traffic on A (reference defaults) and B (layers off),
    alternating by pass; the timed pass's deliveries, picks and cursors
    on A equal B's, and its counts the host path's."""
    from emqx_tpu_torch import device as D
    A, B, H = (nodes[k] for k in "ABH")
    out = {"warm_windows": await _warm_skew(nodes, ids, nums, SEED + 90)}
    for p in range(L_PASSES):
        timed = p == L_PASSES - 1
        windows = _skew_windows(ids, nums, SEED + 91 + p)
        res = {}
        for k in ("AB" if p % 2 == 0 else "BA"):
            node = nodes[k]
            if timed:
                D.reset_launches()
            res[k] = await _skew_pass(node, node.sinks, windows)
            if timed:
                res[k]["launches"] = dict(D.LAUNCHES)
                res[k]["shapes"] = {
                    n: dict(v) for n, v in D.LAUNCH_SHAPES.items()}
        if res["A"]["counts"] != res["B"]["counts"]:
            raise AssertionError(f"9a pass {p}: counts on A != B")
        if res["A"]["got"] != res["B"]["got"]:
            raise AssertionError(f"9a pass {p}: a session's deliveries on "
                                 f"A != B")
        exact(A.device_engine._cursors, B.device_engine._cursors,
              f"9a pass {p} device cursors A vs B")
        host = _host_counts(H, windows)
        if host != res["A"]["counts"]:
            raise AssertionError(f"9a pass {p}: counts on A != the host "
                                 f"path's")
        host_got = _take(H.sinks)
        if [sorted(g) for g in host_got] != [
                sorted(x for w in res["A"]["got"] for x in w[c])
                for c in range(len(host_got))]:
            raise AssertionError(f"9a pass {p}: a session's deliveries on "
                                 f"A != the host path's")
        if timed:
            n = L_WINDOWS * L_W * L_B
            a, bb = res["A"], res["B"]
            la = a["delta"]
            cached = la["routing.device.cached_windows"]
            if cached < 0.9 * L_WINDOWS:
                raise AssertionError(f"9a: {cached} of {L_WINDOWS} timed "
                                     f"windows on A were cached windows")
            if la["match_cache.hits"] <= 0:
                raise AssertionError("9a: no cache hit on A")
            if la["routing.device.cold_cached_class"]:
                raise AssertionError("9a: a cold cached class in the timed "
                                     "pass")
            out["A"], out["B"] = _summary("A", a, n), _summary("B", bb, n)
            for k in "AB":
                out[k]["launches"] = res[k]["launches"]
                out[k]["shape_match_shapes"] = {
                    str(s): c for s, c in
                    res[k]["shapes"]["shape_match"].items()}
            out["scan_shapes"] = res["A"]["shapes"]["prefix_sum"]
            out["windows"] = L_WINDOWS
    out["graphs"] = graph_classes(nodes)
    return out


def graph_classes(nodes) -> dict:
    """Each engine's captured graphs by class (W, Bp, Bm, overlay rows,
    payload)."""
    return {k: [list(key[1:6]) for key in sorted(
        nodes[k].device_engine._graphs, key=lambda t: tuple(
            -1 if x is None else x for x in t))] for k in "AB"}


def _churn_batch(rng, ids: int, nums: int, live: list, seq: int) -> list:
    """tools/churn_bench.py:80-160's batch: C_SHARE of the lanes to the
    live fresh filters' topics churn/{k}/z, the rest uniform."""
    from emqx_tpu_torch.broker.message import make
    out = []
    for j in range(C_BATCH):
        if live and rng.rand() < C_SHARE:
            t = "churn/%d/z" % live[rng.randint(0, len(live))]
        else:
            t = "device/d%d/x/n%d/t" % (rng.randint(0, ids),
                                        rng.randint(0, nums))
        out.append(make("churn", 0, t, b"%d/%d" % (seq, j)))
    return out


async def _churn_cell(nodes: dict, ids: int, nums: int) -> dict:
    """9b: between batches a sink session subscribes C_FRESH fresh
    filters churn/{seq}/+ and unsubscribes the oldest past C_LIVE live;
    route_batch of C_BATCH messages per batch on A, B and the host path
    at the same state. Per batch: every session's deliveries equal on A,
    B and the host path (as multisets: with post-snapshot filters the
    overlay-off engine consumes every message in order, the overlay one
    clean messages first), every fresh-filter lane delivered."""
    import asyncio

    from emqx_tpu_torch import device as D
    names = "ABH"
    churn_sid = {}
    for k in names:
        node = nodes[k]
        node.churn_sink = _Sink()
        churn_sid[k] = node.broker.register(node.churn_sink, "churn-sink")
    live: list = []
    seq = 0
    rng = np.random.RandomState(SEED + 200)
    out = {}
    for p in range(L_PASSES):
        timed = p == L_PASSES - 1
        counters = ("routing.device.messages", *STAGE_US, *LAYER_COUNTERS)
        before = {k: {c: nodes[k].metrics.val(c) for c in counters}
                  for k in "AB"}
        wall = {"A": 0.0, "B": 0.0}
        launches = {k: 0 for k in D.LAUNCHES}
        scans: dict = {}
        for _ in range(C_BATCHES):
            fresh = []
            for _f in range(C_FRESH):
                fresh.append(seq)
                seq += 1
            old = []
            while len(live) + len(fresh) > C_LIVE:
                old.append(live.pop(0))
            live += fresh
            for k in names:
                b = nodes[k].broker
                for q in fresh:
                    b.subscribe(churn_sid[k], f"churn/{q}/+", {"qos": 0})
                for q in old:
                    b.unsubscribe(churn_sid[k], f"churn/{q}/+")
            msgs = _churn_batch(rng, ids, nums, live, seq)
            counts = {}
            for k in "AB":
                D.reset_launches()
                t0 = time.perf_counter()
                counts[k] = nodes[k].device_engine.route_batch(msgs)
                wall[k] += time.perf_counter() - t0
                if k == "A":        # A's launches only
                    for name, c in D.LAUNCHES.items():
                        launches[name] += c
                    for shape, c in D.LAUNCH_SHAPES["prefix_sum"].items():
                        scans[shape] = scans.get(shape, 0) + c
                if counts[k] is None:
                    raise AssertionError(f"9b: {k} declined a batch")
            counts["H"] = _host_counts(nodes["H"], [[msgs]])[0]
            if not counts["A"] == counts["B"] == counts["H"]:
                raise AssertionError(f"9b pass {p}: counts differ")
            got = {k: [sorted(g) for g in _take(nodes[k].sinks)]
                   + [sorted(_take([nodes[k].churn_sink])[0])]
                   for k in names}
            if not got["A"] == got["B"] == got["H"]:
                raise AssertionError(f"9b pass {p}: a session's deliveries "
                                     f"differ between A, B and the host")
            for msg, c in zip(msgs, counts["A"]):
                if msg.topic.startswith("churn/") and c < 1:
                    raise AssertionError(f"9b: {msg.topic} not delivered")
            await asyncio.sleep(0)
        for k in "AB":
            await _settle_warm(nodes[k].device_engine)
        rows = {}
        for k in "AB":
            d = {c: nodes[k].metrics.val(c) - before[k][c]
                 for c in counters}
            rows[k] = {"topic_matches_per_s":
                       C_BATCHES * C_BATCH / wall[k], "wall_s": wall[k],
                       "us_per_msg": stage_us(d),
                       "layers": layer_numbers(d)}
        if timed:
            la = rows["A"]["layers"]
            if la["host_delta"] or la["delta_applies"] <= 0:
                raise AssertionError(f"9b: host_delta {la['host_delta']}, "
                                     f"delta_applies {la['delta_applies']} "
                                     f"on A in the timed pass")
            if la["cold_delta_class"]:
                raise AssertionError("9b: a cold delta class in the timed "
                                     "pass")
            out["A"], out["B"] = rows["A"], rows["B"]
            out["A"]["launches"] = launches
            out["scan_shapes"] = scans
            out["batches"] = C_BATCHES
    A = nodes["A"].device_engine
    ov = A.stats()["overlay"]
    out["overlay_class"] = ov["class"] if ov else None
    out["graphs"] = graph_classes(nodes)
    # one more skew window and one more batch on A alone (they advance
    # A's cursors alone: after every comparison), each window held
    # against the plain path
    hold = await _skew_pass(nodes["A"], nodes["A"].sinks, _skew_windows(
        ids, nums, SEED + 99)[:1], hold=True)
    out["hold_skew_err"] = hold["err"]
    h = A.prepare(_churn_batch(rng, ids, nums, live, seq), gate_cold=False)
    if h.delta is None:
        raise AssertionError("9b: the held window carried no overlay")
    A.dispatch(h)
    A.materialize(h)
    out["hold_err"] = hold_against_plain(A, h, "churn window")
    A.abandon(h)
    return out


def layers_drive(dev, n_filters: int = E2E_FILTERS,
                 n_sub: int = E2E_SUB_CONNS) -> dict:
    """Phase 9: node A at the reference's defaults (dedup, match cache
    8192, delta overlay), node B with those layers off, and a host-path
    node H (never routes on a device), each with phase 8's population
    through broker.subscribe; 9a the skew traffic, 9b the churn traffic.
    Raises on any failed check."""
    import asyncio

    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node

    async def run():
        ids, nums = e2e_grid(n_filters)
        t0 = time.time()
        nodes = {"A": Node({"broker": {}}, device=dev),
                 "B": Node({"broker": dict(LAYERS_OFF)}, device=dev),
                 "H": Node({"broker": dict(LAYERS_OFF)}, device="cpu")}
        for node in nodes.values():
            node.sinks = _populate(node, ids, nums, n_sub)
        t_sub = time.time() - t0
        t0 = time.time()
        for k in "AB":
            eng = nodes[k].device_engine
            eng.route_batch([make("w", 0, "warmup/none/t", b"")
                             for _ in range(L_B)])
            if eng._built is None:
                raise AssertionError("phase 9: no snapshot")
        gc.collect()
        gc.freeze()
        try:
            skew = await _skew_cell(nodes, ids, nums)
            churn = await _churn_cell(nodes, ids, nums)
        finally:
            gc.unfreeze()
        for k in "AB":
            eng = nodes[k].device_engine
            if eng.failed is not None:
                raise AssertionError(f"phase 9: engine {k} failed") \
                    from eng.failed
        supervise = {k: check_supervised(node, f"phase 9 node {k}")
                     for k, node in nodes.items()}
        return {"filters": ids * nums, "subscribe_s": t_sub,
                "build_s": time.time() - t0, "skew": skew, "churn": churn,
                "supervise": supervise,
                "capture": {k: {"captures": nodes[k].device_engine.captures,
                                "capture_s": nodes[k].device_engine.capture_s}
                            for k in "AB"},
                "stats": {k: nodes[k].device_engine.stats() for k in "AB"}}

    return asyncio.run(run())


def layers_phase(dev, card: str) -> dict:
    """Phase 9 at the e2e population on the card; prints its lines."""
    t0 = time.time()
    r = layers_drive(dev)
    sk, ch = r["skew"], r["churn"]
    log(f"phase 9: {r['filters']} filters on nodes A (dedup, match cache "
        f"8192, delta overlay) and B (all off) and the host path, "
        f"subscribed in {r['subscribe_s']:.1f} s")
    log(f"phase 9a skew: {sk['warm_windows']} warm-up windows; every pass "
        f"of {sk['windows']} windows of {L_W} x {L_B}: deliveries, shared "
        f"picks and device cursors A == B, counts and per-session "
        f"deliveries A == host path; graphs {sk['graphs']}")
    for k in "AB":
        log(f"phase 9a {k}: {json.dumps(sk[k])}")
    log(f"phase 9b churn: timed pass of {ch['batches']} route_batch of "
        f"{C_BATCH}: per-session deliveries A == B == host path, every "
        f"fresh-filter lane delivered; overlay class {ch['overlay_class']}, "
        f"graphs {ch['graphs']}")
    for k in "AB":
        log(f"phase 9b {k}: {json.dumps(ch[k])}")
    for k in "AB":
        st = r["stats"][k]
        log(f"phase 9 {k}: subscription_covering "
            f"{st['subscription_covering']}, cover {json.dumps(st['cover'])}"
            f", detection {st['cover_detect_s']} s")
    log(f"phase 9: a cached window (9a) and an overlay window (9b) == plain "
        f"path: every plane, both CSR payloads, cursors (exact); captures "
        f"{json.dumps(r['capture'])}; supervisors (A, B, H) noted "
        f"{json.dumps(r['supervise'])}; phase 9 {time.time() - t0:.1f} s")
    log(card)
    return r


# ---- phase 10: subscription covering on the card --------------------------

# tools/cover_bench.py:53-175: its default population (10,000 filters,
# cover ratio 0.6) and phase 8's scale; 32 batches of 1,024 topics drawn
# uniformly from concretize(filter) over the whole population
COVER_CELLS = (10_000, 100_000)
COVER_RATIO = 0.6
COVER_B = 1024
COVER_BATCHES = 16         # 32 before QUIC
COVER_PASSES = 1           # timed passes after the warm pass (2 before
                           # QUIC); the best
COVER_CONF = {"topic_dedup": False, "device_fanout_cap": 4,
              "device_slot_cap": 2}


def _cover_node(dev, filters: list, covering: bool):
    """One of cover_bench's twin nodes: dedup off, fan-out cap 4, slot
    cap 2, one session subscribed to every filter at QoS 0."""
    from emqx_tpu_torch.broker.node import Node
    node = Node({"broker": dict(COVER_CONF,
                                subscription_covering=covering)},
                device=dev)
    node.sink = _Sink()
    node.sid = node.broker.register(node.sink, "cover")
    for f in filters:
        node.broker.subscribe(node.sid, f, {"qos": 0})
    return node


# the run's peak device memory before each reset of the peak counter
_RUN_PEAK = [0]


def _cover_graph(eng, h, mem: dict) -> None:
    """On the card, capture the graph of a shape-hash window's class if
    it has none yet (what the background warm does for a class traffic
    asks for), with its seconds and the device memory it took: the
    capture's peak allocation past what was allocated before it, and the
    memory the caching allocator reserved for it."""
    import torch
    if eng.device.type != "cuda" or h.built.backend != "shapes":
        return
    Wp, Bp = h.enc[0].shape[:2]
    cls = (Wp, Bp, h.plan.Bm if h.plan is not None else None,
           h.delta.cap if h.delta is not None else None, h.pcap)
    if eng._graph_key(h.built, cls, eng._strategy()) in eng._graphs:
        return
    torch.cuda.synchronize()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    _RUN_PEAK[0] = max(_RUN_PEAK[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    with torch.cuda.stream(eng._warm_stream):
        eng._warm_dispatch(h.built, eng._tables, eng._cursors, cls)
    torch.cuda.synchronize()
    mem["peak_mb"] = max(mem.get("peak_mb", 0.0),
                         (torch.cuda.max_memory_allocated() - a0) / 1e6)
    mem["reserved_mb"] = mem.get("reserved_mb", 0.0) \
        + (torch.cuda.memory_reserved() - r0) / 1e6


def _cover_pass(node, batches: list, mem: dict, hold: bool = False):
    """One pass of single-batch windows through prepare → dispatch →
    materialize (consume excluded, as in cover_bench: it is the same on
    both nodes), a class's graph captured untimed when it has none; with
    `hold` every window is held against the plain path. Returns the
    window latencies, the graph replays, and max |diff|."""
    eng = node.device_engine
    lat, graphed, err = [], 0, 0
    for msgs in batches:
        t0 = time.perf_counter()
        h = eng.prepare(msgs, gate_cold=False)
        if h is None:
            raise AssertionError("phase 10: no snapshot")
        t1 = time.perf_counter()
        _cover_graph(eng, h, mem)
        t2 = time.perf_counter()
        eng.dispatch(h)
        eng.materialize(h)
        lat.append(time.perf_counter() - t0 - (t2 - t1))
        graphed += h.graphed
        if hold:
            err = max(err, hold_against_plain(eng, h, "covered window"))
        eng.abandon(h)
    return lat, graphed, err


def _per_msg(got: list) -> list:
    """One session's deliveries (payload, filter) as each message's
    filters, by message. Where one path completes a message on the host
    and the other on the device, the orders part, both as the reference
    has them: within a message the host path walks its trie where the
    device keeps the matcher's order, and a window delivers its clean
    messages before those it completes on the host or through the
    overlay (a lane flagged overflow — every lane under a root past the
    candidate capacity — completes on the host)."""
    out: dict = {}
    for payload, f in got:
        out.setdefault(payload, []).append(f)
    return sorted((k, sorted(v)) for k, v in out.items())


def _cover_cell(dev, n: int, seed: int) -> dict:
    """One population of phase 10 on nodes A (covering on) and B (off)."""
    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.workloads import concretize, cover_heavy_filters
    sync = _sync(dev)
    filters = cover_heavy_filters(n, cover_ratio=COVER_RATIO)
    rng = np.random.RandomState(seed)
    pool = [concretize(f) for f in filters]
    batches = [[make("p", 0, pool[i], b"x") for i in
                rng.randint(0, len(pool), COVER_B)]
               for _ in range(COVER_BATCHES)]
    out = {"filters": n, "unique": len(set(filters))}
    nodes = {}
    for name, on in (("A", True), ("B", False)):
        t0 = time.time()
        node = nodes[name] = _cover_node(dev, filters, on)
        t_sub = time.time() - t0
        eng = node.device_engine
        t0 = time.time()
        eng.rebuild()
        sync()
        st = eng.stats()
        out[name] = {"subscribe_s": t_sub, "build_s": time.time() - t0,
                     "detect_s": eng.detect_s, "backend": st["backend"],
                     "cover": st["cover"], "mem": {}}
    if out["A"]["cover"] is None or out["B"]["cover"] is not None:
        raise AssertionError(f"phase 10: cover state A {out['A']['cover']}"
                             f" B {out['B']['cover']}")
    for name in "AB":
        _cover_pass(nodes[name], batches, out[name]["mem"])   # warm pass
    for name in "AB":
        eng = nodes[name].device_engine
        r = out[name]
        c0, t0 = eng.captures, eng.capture_s
        if name == "A":
            sync()
            D.reset_launches()
        best = None
        for _ in range(COVER_PASSES):
            lat, graphed, _e = _cover_pass(nodes[name], batches, r["mem"])
            if best is None or sum(lat) < sum(best[0]):
                best = (lat, graphed)
        if name == "A":
            sync()
            r["launches"] = dict(D.LAUNCHES)
            r["scan_shapes"] = {k: v / (COVER_PASSES * COVER_BATCHES)
                                for k, v in
                                D.LAUNCH_SHAPES["prefix_sum"].items()}
        lat_ms = np.array(best[0]) * 1e3
        r.update({"topic_matches_per_s": COVER_BATCHES * COVER_B
                  / float(np.sum(best[0])),
                  "window_p50_ms": float(np.percentile(lat_ms, 50)),
                  "window_p99_ms": float(np.percentile(lat_ms, 99)),
                  "graphed": best[1], "windows": COVER_BATCHES,
                  "graphs": len(eng._graphs), "captures": eng.captures,
                  "capture_s": eng.capture_s,
                  "timed_captures": eng.captures - c0,
                  "timed_capture_s": eng.capture_s - t0})
    a = nodes["A"].device_engine
    if dev.type == "cuda" and out["A"]["backend"] == "shapes" \
            and out["A"]["graphed"] != COVER_BATCHES:
        raise AssertionError(f"phase 10: {out['A']['graphed']} of "
                             f"{COVER_BATCHES} covered windows replayed")
    # every covered window against the plain path, bit for bit
    _l, _g, out["hold_err"] = _cover_pass(nodes["A"], batches,
                                          out["A"]["mem"], hold=True)
    if out["A"]["backend"] == "shapes":
        # one fused window of 8 batches (the (8, 1024) class, 8,192
        # lanes expanded and verified at once): its capture's memory,
        # and the window against the plain path
        h = a.prepare_window(batches[:8], gate_cold=False)
        out["A"]["fused_mem"] = {}
        _cover_graph(a, h, out["A"]["fused_mem"])
        a.dispatch(h)
        a.materialize(h)
        out["A"]["fused_graphed"] = h.graphed
        out["hold_err"] = max(out["hold_err"], hold_against_plain(
            a, h, "covered fused window"))
        a.abandon(h)

    # A, B and the host path deliver identically on a full route_batch
    check = [make("c", 0, pool[i], b"%d" % k) for k, i in
             enumerate(rng.randint(0, len(pool), COVER_B))]
    got = {}
    for name in "AB":
        node = nodes[name]
        counts = node.device_engine.route_batch(check)
        if counts is None:
            raise AssertionError(f"phase 10: node {name} routed nothing")
        got[name] = (counts, node.sink.got)
        node.sink.got = []
    b = nodes["B"]
    got["H"] = ([b.broker._route(m, b.router.match(m.topic))
                 for m in check], b.sink.got)
    b.sink.got = []
    # the same deliveries of every message on every path (_per_msg)
    want = (got["A"][0], _per_msg(got["A"][1]))
    for name in "BH":
        if (got[name][0], _per_msg(got[name][1])) != want:
            raise AssertionError(f"phase 10: node A and {name} deliver "
                                 f"differently")
    out["same_order"] = got["A"][1] == got["B"][1]
    out["host_fallback"] = {name: nodes[name].metrics.val(
        "routing.device.host_fallback") for name in "AB"}
    out["delivered"] = sum(got["A"][0])

    # one covered SUBSCRIBE after the warm-up: an append on A (no overlay
    # row), an overlay row on B; the next window delivers it alike
    roots = a._built.cover.roots.tolist()
    umb = next(a._built.fid_filter[f] for f in roots
               if a._built.fid_filter[f].endswith("/#"))
    new = umb[:-1] + "coverednew/leaf"
    for name in "AB":
        node = nodes[name]
        node.late = _Sink()
        node.broker.subscribe(node.broker.register(node.late, "late"),
                              new, {"qos": 0})
    sa = a.stats()
    if nodes["A"].metrics.val("routing.cover.appends") != 1 \
            or sa["delta_filters"] != 0 \
            or nodes["B"].device_engine.stats()["delta_filters"] != 1:
        raise AssertionError(f"phase 10: the covered SUBSCRIBE did not "
                             f"land as an append: {sa['cover']}, delta "
                             f"filters {sa['delta_filters']}")
    win = [make("n", 0, t, b"%d" % k) for k, t in enumerate(
        [concretize(new)] * 8 + [pool[i] for i in
                                 rng.randint(0, len(pool), 120)])]
    seen = {}
    for name in "AB":
        node = nodes[name]
        eng = node.device_engine
        h = eng.prepare(win, gate_cold=False)
        if name == "A":
            _cover_graph(eng, h, out["A"]["mem"])
        eng.dispatch(h)
        eng.materialize(h)
        if name == "A":
            out["append_graphed"] = h.graphed
            if dev.type == "cuda" and out["A"]["backend"] == "shapes" \
                    and not h.graphed:
                raise AssertionError("phase 10: the window after the "
                                     "append was not a graph replay")
            out["hold_err"] = max(out["hold_err"], hold_against_plain(
                eng, h, "covered window after the append"))
        seen[name] = (eng.finish(h), _per_msg(node.sink.got),
                      node.late.got)
    if seen["A"] != seen["B"] or len(seen["A"][2]) != 8:
        diff = [k for k in range(3) if seen["A"][k] != seen["B"][k]]
        raise AssertionError(
            f"phase 10: the appended filter delivered differently from "
            f"the off twin (parts {diff}: counts, session, new session; "
            f"{len(seen['A'][2])} / {len(seen['B'][2])} to the new one)")
    out["stats_A"] = a.stats()
    out["supervise"] = {k: check_supervised(node, f"phase 10 {n} node {k}")
                        for k, node in nodes.items()}
    return out


def _sync(dev):
    import torch
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def cover_drive(dev, cells=None, seed: int = SEED) -> dict:
    """Phase 10 over every population of COVER_CELLS. Raises on any
    failed check."""
    return {n: _cover_cell(dev, n, seed + k)
            for k, n in enumerate(cells or COVER_CELLS)}


def cover_phase(dev, card: str) -> dict:
    """Phase 10 on the card; prints its lines."""
    t0 = time.time()
    r = cover_drive(dev)
    for n, c in r.items():
        for name in "AB":
            x = c[name]
            log(f"phase 10 {n} {name} (covering {'on' if name == 'A' else 'off'}): "
                f"backend {x['backend']}, cover {json.dumps(x['cover'])}, "
                f"{x['topic_matches_per_s']:.0f} topic-matches/s, window "
                f"p50 {x['window_p50_ms']:.3f} ms, p99 "
                f"{x['window_p99_ms']:.3f} ms ({x['graphed']} of "
                f"{x['windows']} graph replays); detection "
                f"{x['detect_s']:.2f} s, build {x['build_s']:.2f} s, "
                f"subscribe {x['subscribe_s']:.1f} s; {x['graphs']} graph "
                f"classes, {x['captures']} captures in "
                f"{x['capture_s']:.2f} s; capture memory "
                f"{json.dumps({k: round(v, 1) for k, v in x['mem'].items()})}"
                f" MB" + (f"; the fused (8, {COVER_B}) window's capture "
                          f"{json.dumps({k: round(v, 1) for k, v in x['fused_mem'].items()})}"
                          f" MB (graph replay: {x['fused_graphed']})"
                          if "fused_mem" in x else ""))
        log(f"phase 10 {n}: {c['unique']} unique filters; A on / B off "
            f"{c['A']['topic_matches_per_s'] / c['B']['topic_matches_per_s']:.3f}"
            f"; every covered window == plain path (exact); A == B == "
            f"host path on a route_batch of {COVER_B} ({c['delivered']} "
            f"deliveries, each message's; in the same order on A and B: "
            f"{c['same_order']}; host fallbacks {c['host_fallback']}); a "
            f"covered SUBSCRIBE landed as an append and "
            f"the next window (graph replay: {c['append_graphed']}) "
            f"delivered it as the off twin; launches on A's timed passes "
            f"{c['A']['launches']}; supervisors noted "
            f"{json.dumps(c['supervise'])}")
    log(f"phase 10 {time.time() - t0:.1f} s")
    log(card)
    return r


# ---- phase 11: columnar PUBLISH ingress ------------------------------------

# tools/ingress_bench.py:52-215: connections x 400 pre-serialized QoS 0
# PUBLISHes of 64 bytes over 16 topics; the subscriber holds 1 of them
I_CONNS = (64, 256)
I_MSGS = 200               # a connection's flood (400 before QUIC)
I_TOPICS = 16
I_PAYLOAD = 64
I_SUB_TOPICS = 1
I_TIMEOUT_S = 240         # a timed flood must settle within this
I_ONE_TIMEOUT_S = 300     # one configuration's subprocess


def _ingress_blob(conn_id: int, n_msgs: int, n_topics: int,
                  payload: int) -> bytes:
    """One publisher's whole flood, pre-serialized QoS 0 PUBLISH frames
    (the payload starts with the connection and the sequence number)."""
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.frame import serialize
    pad = b"x" * max(0, payload - 16)
    return b"".join(serialize(P.Publish(
        topic=f"bench/t{i % n_topics}",
        payload=b"%08d%08d" % (conn_id, i) + pad), 4)
        for i in range(n_msgs))


async def _connect_raw(port: int, clientid: str):
    """CONNECT over a raw socket; returns (reader, writer) past the
    CONNACK."""
    import asyncio

    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.frame import FrameParser, serialize
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(serialize(P.Connect(proto_name="MQTT", proto_ver=4,
                                     clientid=clientid), 4))
    await writer.drain()
    parser = FrameParser(version=4)
    while True:
        data = await reader.read(64)
        if not data:
            raise AssertionError("connection closed before CONNACK")
        if parser.feed(data):
            return reader, writer


async def _ingress_run(dev, conns: int, columnar: bool, n_msgs: int,
                       n_topics: int, payload: int, sub_topics: int,
                       timeout_s: float) -> dict:
    import asyncio

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch import native
    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.client import Client

    node = Node({"broker": {"columnar_ingress": columnar}}, device=dev)
    # phase 11 measures the ingress layer in front of the device path, so
    # both runs route every window on the device: on this traffic (1 of
    # 16 topics subscribed) the host route costs about what a device
    # window does a message, within the chooser's margin, and a free
    # chooser flipped between runs (PERF.md, Findings: 0.44 against 1.00
    # on the device), so on / off compared routing paths, not ingress.
    # Phase 8 drives the chooser.
    node.publish_batcher._device_worth_it = lambda: True
    m = node.metrics
    lst = Listener(node, bind="127.0.0.1", port=0)
    await lst.start()
    sub = Client(port=lst.port, clientid="ingress-sub")
    await sub.connect()
    for k in range(sub_topics):
        await sub.subscribe(f"bench/t{k}", qos=0)
    delivered = [0]
    order_violations = [0]
    last_seq: dict = {}

    async def drain_sub():
        # per-publisher order: the payload is b"%08d%08d" (conn, seq)
        while True:
            msg = await sub.messages.get()
            delivered[0] += 1
            head = bytes(msg.payload[:16])
            c, k = int(head[:8]), int(head[8:])
            if last_seq.get(c, -1) >= k:
                order_violations[0] += 1
            last_seq[c] = k

    async def flood(pairs, blobs):
        async def one(writer, blob):
            for w in range(0, len(blob), 65536):
                writer.write(blob[w:w + 65536])
                await writer.drain()
        await asyncio.gather(*[one(w, b) for (_r, w), b in zip(pairs,
                                                                blobs)])

    async def settle(expect: int, deadline: float) -> bool:
        while time.perf_counter() < deadline:
            if m.val("messages.publish") >= expect:
                return True
            await asyncio.sleep(0.02)
        return False

    drainer = asyncio.get_running_loop().create_task(drain_sub())
    pairs = []
    try:
        # the warm pass (not timed): the flood's batch classes, the
        # allocator and the lanes; then wait for the snapshot and the
        # background warm of its classes, or the timed windows would run
        # on the host while they are cold
        n_warm = min(conns, 8)
        warm = [await _connect_raw(lst.port, f"warm{i}")
                for i in range(n_warm)]
        await flood(warm, [_ingress_blob(900 + i, n_msgs, n_topics,
                                         payload) for i in range(n_warm)])
        await settle(n_warm * n_msgs, time.perf_counter() + 120)
        for _r, w in warm:
            w.close()
        eng = node.device_engine
        bmax = node.publish_batcher.max_batch
        deadline = time.perf_counter() + 90
        while time.perf_counter() < deadline:
            if eng._built is not None and eng.batch_class_warm(bmax) \
                    and getattr(eng, "_fuse_warm_task", None) is None:
                break
            await asyncio.sleep(0.05)
        pairs = [await _connect_raw(lst.port, f"pub{i}")
                 for i in range(conns)]
        blobs = [_ingress_blob(i, n_msgs, n_topics, payload)
                 for i in range(conns)]
        keys = ("messages.publish", "routing.device.batches",
                "routing.device.windows",
                "routing.device.messages", "routing.host.messages",
                *STAGE_US)
        before = {k: m.val(k) for k in keys}
        tele0 = tele_state(node)
        total = conns * n_msgs
        gc.collect()
        base = delivered[0]
        D.reset_launches()
        t0 = time.perf_counter()
        await flood(pairs, blobs)
        ok = await settle(before["messages.publish"] + total,
                          t0 + timeout_s)
        wall = time.perf_counter() - t0
        launches = dict(D.LAUNCHES)
        scan_shapes = dict(D.LAUNCH_SHAPES["prefix_sum"])
        # let the deliveries in flight land: until the count stops moving
        stable, quiet = delivered[0], 0
        deadline = time.perf_counter() + 30
        while quiet < 10 and time.perf_counter() < deadline:
            await asyncio.sleep(0.05)
            if delivered[0] == stable:
                quiet += 1
            else:
                stable, quiet = delivered[0], 0
        delta = {k: m.val(k) - v for k, v in before.items()}
        tele = tele_delta(node, tele0)
        snap = node.pipeline_telemetry.snapshot()
        # one window of the flood's own topic sequence, fused as the
        # flood's are, held against the plain path (16 unique topics: the
        # dedup plan's window)
        seq = [f"bench/t{i % n_topics}" for i in range(bmax)]
        hold_err = hold_window(eng, [[make("cmp", 0, t, b"") for t in seq]
                                     for _ in range(2)],
                               "ingress window", True)
    finally:
        drainer.cancel()
        for _r, w in pairs:
            w.close()
        await sub.close()
        await lst.stop()
        await node.publish_batcher.stop()
        node.publish_batcher.close()
    return {"conns": conns, "columnar": bool(columnar), "msgs": total,
            "completed": ok, "wall_s": wall,
            "msgs_per_s": round(total / wall) if ok and wall > 0 else 0,
            "delivered": delivered[0] - base,
            # each publisher's messages on the subscribed topics
            "expected": conns * sum(len(range(k, n_msgs, n_topics))
                                    for k in range(sub_topics)),
            "order_violations": order_violations[0],
            # the messages the device engine routed (matched or not: the
            # subscriber holds 1 of the 16 topics)
            "device_share": delta["routing.device.messages"] / total,
            "device_batches": delta["routing.device.batches"],
            "device_windows": delta["routing.device.windows"],
            "device_us_per_msg": stage_us(delta),
            "ingress": snap.get("ingress"), "stages": tele["stages"],
            "decisions": tele["decisions"], "lanes": node.ingress_lanes,
            "launches": launches, "hold_err": hold_err,
            "scan_shapes": [[list(k), v] for k, v in scan_shapes.items()],
            "native": native.available(),
            "supervise": check_supervised(
                node, f"phase 11 {conns} columnar {columnar}"),
            "device": str(dev)}


def ingress_one(dev, conns: int, columnar: bool, n_msgs: int = I_MSGS,
                n_topics: int = I_TOPICS, payload: int = I_PAYLOAD,
                sub_topics: int = I_SUB_TOPICS,
                timeout_s: float = I_TIMEOUT_S) -> dict:
    """One phase-11 configuration: a node with columnar ingress on or off,
    a warm pass, then `conns` publishers each writing its pre-serialized
    flood at once; msgs/s over the flood, the deliveries and their order,
    the stage decomposition and the `ingress` section."""
    import asyncio

    import torch
    return asyncio.run(_ingress_run(torch.device(dev), conns, columnar,
                                    n_msgs, n_topics, payload, sub_topics,
                                    timeout_s))


def check_ingress_pair(on: dict, off: dict) -> None:
    """Columnar on and off deliver the same, known number of messages, in
    order, both complete, at least E2E_MIN_DEVICE_SHARE of them routed on the
    device; on takes the burst path on the native library, off has no
    ingress section. (Each run's window held against the plain path
    raised in its child if it disagreed.)"""
    for r in (on, off):
        if not r["completed"]:
            raise AssertionError(f"phase 11 {r['conns']} columnar "
                                 f"{r['columnar']}: the flood did not "
                                 f"settle")
        if r["delivered"] != r["expected"]:
            raise AssertionError(f"phase 11 {r['conns']} columnar "
                                 f"{r['columnar']}: delivered "
                                 f"{r['delivered']}, expected "
                                 f"{r['expected']}")
        if r["device_share"] < E2E_MIN_DEVICE_SHARE:
            raise AssertionError(f"phase 11 {r['conns']} columnar "
                                 f"{r['columnar']}: {r['device_share']:.3f} "
                                 f"of the messages on the device")
        if r["order_violations"]:
            raise AssertionError(f"phase 11 {r['conns']}: "
                                 f"{r['order_violations']} deliveries out "
                                 f"of publisher order")
    if on["delivered"] != off["delivered"]:
        raise AssertionError(f"phase 11 {on['conns']}: columnar on "
                             f"delivered {on['delivered']}, off "
                             f"{off['delivered']}")
    if not (on["ingress"] or {}).get("bursts"):
        raise AssertionError(f"phase 11 {on['conns']}: no PublishBurst "
                             f"with columnar ingress on")
    if off["ingress"] is not None:
        raise AssertionError(f"phase 11 {off['conns']}: an ingress section "
                             f"with columnar ingress off")
    if not on["native"]:
        raise AssertionError("phase 11: the columnar run used the "
                             "pure-Python mirrors, not the host library")


def ingress_phase(card: str) -> dict:
    """Phase 11 on the card, each configuration in a process of its own
    (no configuration inherits another's collector state or graphs), all
    of them started at once and run one after another."""
    t0 = time.time()
    rows = {}
    kids = {(c, col): _Child("--ingress") for c in I_CONNS
            for col in (False, True)}
    for conns in I_CONNS:
        for columnar in (False, True):
            arg = json.dumps({"conns": conns, "columnar": columnar})
            rc, out, err = kids[(conns, columnar)].run(arg, I_ONE_TIMEOUT_S)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if rc != 0 or not lines:
                raise AssertionError(
                    f"phase 11 {conns} columnar {columnar}: the child "
                    f"failed, rc {rc}: {err[-2000:]}")
            r = rows[(conns, columnar)] = json.loads(lines[-1])
            stage_ms = {k: v["sum_ms"] for k, v in r["stages"].items()}
            log(f"phase 11 {conns} connections, columnar "
                f"{'on' if columnar else 'off'}: {r['msgs_per_s']} msgs/s "
                f"({r['msgs']} in {r['wall_s']:.3f} s), delivered "
                f"{r['delivered']}, {r['device_share']:.3f} on the device "
                f"({r['device_windows']} windows), lanes {r['lanes']}, "
                f"native {r['native']}, window == plain path (max |diff| "
                f"{r['hold_err']}); us per device message "
                f"{json.dumps({k: round(v, 2) for k, v in r['device_us_per_msg'].items()})}"
                f"; kernel 2 launches by shape "
                f"{json.dumps({str(tuple(k)): v for k, v in r['scan_shapes']})}"
                f"; stage ms {json.dumps(stage_ms)}; ingress "
                f"{json.dumps(r['ingress'])}; launches {r['launches']}; "
                f"supervisor noted {json.dumps(r['supervise'])}")
    for conns in I_CONNS:
        on, off = rows[(conns, True)], rows[(conns, False)]
        check_ingress_pair(on, off)
        log(f"phase 11 {conns} connections: columnar on / off "
            f"{on['msgs_per_s']} / {off['msgs_per_s']} msgs/s "
            f"({on['msgs_per_s'] / max(1, off['msgs_per_s']):.3f}x); both "
            f"delivered the {on['delivered']} expected in publisher order")
    log(f"phase 11 {time.time() - t0:.1f} s")
    log(card)
    return {f"{c} {'on' if col else 'off'}": r
            for (c, col), r in rows.items()}




# ---- phase 12: the overload governor -------------------------------------

# tools/overload_bench.py:1-60: 16 connections, QoS 0 rows with every 16th
# row at QoS 1, 8 topics, 64-byte payloads, the governor polled every
# 0.05 s, a 500 ms objective (set on a CPU: recorded, not asserted)
O_CONNS = 16
O_MSGS = 7000               # per connection, the bench's; cut by O_FLOOD_S
O_QOS1_EVERY = 16
O_TOPICS = 8
O_PAYLOAD = 64
O_SLO_MS = 500.0
O_POLL_S = 0.05
O_RATE_X = 2.0              # the paced flood's rate: x the warm pass's
O_FLOOD_S = 20.0            # a flood's planned length at most
O_WARM_MSGS = 1000          # per connection in the warm pass
O_DOWN_SUSTAIN = 200        # the bench's: the flood stays shed while timed
O_RECOVER_S = 30.0
O_TIMEOUT_S = 120.0
O_ONE_TIMEOUT_S = 300


def _overload_blob(conn_id: int, n_msgs: int, n_topics: int, payload: int,
                   qos1_every: int) -> bytes:
    """tools/overload_bench.py:52-73: one publisher's flood,
    pre-serialized — QoS 0 rows with a QoS 1 row every `qos1_every`
    frames on a topic family of its own; the payload starts with (conn,
    seq) for the per-publisher order check."""
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.frame import serialize
    out = bytearray()
    pad = b"x" * max(0, payload - 16)
    pid = 0
    for i in range(n_msgs):
        head = b"%08d%08d" % (conn_id, i)
        if qos1_every and i % qos1_every == qos1_every - 1:
            pid = pid % 65535 + 1
            out += serialize(P.Publish(topic=f"ov/q1/t{i % n_topics}",
                                       payload=head + pad, qos=1,
                                       packet_id=pid), 4)
        else:
            out += serialize(P.Publish(topic=f"ov/q0/t{i % n_topics}",
                                       payload=head + pad, qos=0), 4)
    return bytes(out)


async def _overload_run(dev, governor: bool, rate, conns: int, n_msgs: int,
                        warm_msgs: int, flood_s: float,
                        poll_s: float = O_POLL_S) -> dict:
    """One phase-12 twin: the node with the governor on or off, the
    chooser held on the device; a warm pass (every class captured, then
    `warm_msgs` a connection written at once) measures the node's
    sustained msgs/s with the governor not yet polled; then the paced
    flood at `rate` msgs/s (O_RATE_X x the warm pass's when None) of at
    most `flood_s` seconds (`n_msgs` a connection, cut to fit), the
    governor polled every `poll_s`, the observatory reset once the flood
    is steady (the bench's rule); the QoS 1 settle, and the recovery."""
    import asyncio

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.broker.overload import GRADES
    from emqx_tpu_torch.client import Client

    node = Node({"broker": {"overload": governor,
                            "slo_route_p99_ms": O_SLO_MS}}, device=dev)
    node.publish_batcher._device_worth_it = lambda: True
    m = node.metrics
    gov = node.overload_governor
    lst = Listener(node, bind="127.0.0.1", port=0)
    await lst.start()
    sub = Client(port=lst.port, clientid="ov-sub")
    await sub.connect()
    # QoS 0 grants: deliveries are plain socket writes, so the
    # subscriber's inflight window never becomes the wall (the bench's)
    await sub.subscribe("ov/q1/#", qos=0)
    await sub.subscribe("ov/q0/#", qos=0)
    got = {"q0": 0, "q1": 0, "order": 0}
    last_seq: dict = {}

    async def drain_sub():
        while True:
            msg = await sub.messages.get()
            head = bytes(msg.payload[:16])
            c, k = int(head[:8]), int(head[8:])
            if msg.topic.startswith("ov/q1/"):
                got["q1"] += 1
                # QoS 0 rows may be shed between them: monotone per
                # publisher, not contiguous
                if last_seq.get(c, -1) >= k:
                    got["order"] += 1
                last_seq[c] = k
            else:
                got["q0"] += 1

    async def write_all(pairs, blobs):
        async def one(w, blob):
            for x in range(0, len(blob), 65536):
                w.write(blob[x:x + 65536])
                await w.drain()
        await asyncio.gather(*[one(w, b) for (_r, w), b in zip(pairs,
                                                                blobs)])

    async def quiet(fn, polls: int = 10, limit: float = 30.0) -> None:
        """Wait until fn() stops moving for `polls` polls."""
        last, n = fn(), 0
        deadline = time.perf_counter() + limit
        while n < polls and time.perf_counter() < deadline:
            await asyncio.sleep(0.05)
            cur = fn()
            n, last = (n + 1, last) if cur == last else (0, cur)

    async def sink(reader):
        try:                  # the PUBACKs must be read, or the
            while True:       # publisher's receive buffer fills
                if not await reader.read(65536):
                    return
        except (ConnectionError, OSError):
            return

    drainer = asyncio.get_running_loop().create_task(drain_sub())
    pairs, sinks, tasks = [], [], []
    try:
        # the warm pass: the flood's classes captured before anything is
        # timed, then the node's sustained rate on this host
        w_pairs = [await _connect_raw(lst.port, f"ovwarm{i}")
                   for i in range(conns)]
        sinks += [asyncio.get_running_loop().create_task(sink(r))
                  for r, _w in w_pairs]
        await write_all(w_pairs[:1], [_overload_blob(
            900, 256, O_TOPICS, O_PAYLOAD, 0)])
        eng = node.device_engine
        bmax = node.publish_batcher.max_batch
        deadline = time.perf_counter() + 90
        while time.perf_counter() < deadline:
            if eng._built is not None and eng.batch_class_warm(bmax) \
                    and getattr(eng, "_fuse_warm_task", None) is None:
                break
            await asyncio.sleep(0.05)
        await quiet(lambda: got["q0"] + got["q1"])
        # sustained = delivered: the subscriber holds every topic
        want = got["q0"] + got["q1"] + conns * warm_msgs
        t0 = time.perf_counter()
        await write_all(w_pairs, [_overload_blob(
            910 + i, warm_msgs, O_TOPICS, O_PAYLOAD, O_QOS1_EVERY)
            for i in range(conns)])
        while got["q0"] + got["q1"] < want \
                and time.perf_counter() - t0 < O_TIMEOUT_S:
            await asyncio.sleep(0.005)
        warm_s = time.perf_counter() - t0
        warm_rate = conns * warm_msgs / warm_s
        if got["q0"] + got["q1"] < want:
            raise AssertionError("phase 12: the warm pass did not settle")
        for _r, w in w_pairs:
            w.close()
        if rate is None:
            rate = O_RATE_X * warm_rate
        n = max(O_QOS1_EVERY, min(n_msgs, int(rate * flood_s / conns)))
        got.update(q0=0, q1=0, order=0)
        last_seq.clear()

        # the paced flood, the governor polled from here on
        node.start_timers(poll_s)
        if gov is not None:
            gov.up_sustain = 2
            gov.down_sustain = O_DOWN_SUSTAIN
            gov.thresholds = dict(gov.thresholds,
                                  queue_fill=(0.25, 0.45, 0.65))
        pairs = [await _connect_raw(lst.port, f"ovpub{i}")
                 for i in range(conns)]
        sinks += [asyncio.get_running_loop().create_task(sink(r))
                  for r, _w in pairs]
        blobs = [_overload_blob(i, n, O_TOPICS, O_PAYLOAD, O_QOS1_EVERY)
                 for i in range(conns)]
        q1_sent = conns * len(range(O_QOS1_EVERY - 1, n, O_QOS1_EVERY))
        frame_bytes = len(blobs[0]) / n
        timeline = []

        async def paced(writer, blob):
            bps = frame_bytes * rate / conns
            w = 0
            start = time.perf_counter()
            try:
                while w < len(blob):
                    due = int(bps * (time.perf_counter() - start + 0.02))
                    if due > w:
                        writer.write(blob[w:due])
                        w = due
                        await writer.drain()
                    await asyncio.sleep(0.02)
            except (ConnectionError, OSError):
                # the critical grade's offender disconnect: the rest of
                # this publisher's rows were never accepted
                pass

        async def grades(t0):
            last = None
            while gov is not None:
                if gov.grade != last:
                    last = gov.grade
                    timeline.append((round(time.perf_counter() - t0, 3),
                                     GRADES[last]))
                await asyncio.sleep(poll_s / 2)

        # the flood's windows by path: device, and on the host those of
        # at least device_min_batch rows (the chooser's to send) apart
        # from the smaller ones (the host's by rule)
        b = node.publish_batcher
        wins = {"device": 0, "host": 0, "host_small": 0}
        record = b._record_decision

        def tally(group, lives, dispatched):
            if dispatched:
                wins["device"] += 1
            else:
                for e in group:
                    wins["host" if len(e["live"]) >= b.device_min_batch
                         else "host_small"] += 1
            record(group, lives, dispatched)

        b._record_decision = tally
        keys = ("routing.device.messages", "routing.host.messages",
                "messages.qos1.received", "messages.publish")
        before = {k: m.val(k) for k in keys}
        gc.collect()
        D.reset_launches()
        t0 = time.perf_counter()
        tasks.append(asyncio.get_running_loop().create_task(grades(t0)))
        flood = asyncio.gather(*[paced(w, blob)
                                 for (_r, w), blob in zip(pairs, blobs)])
        steady = time.perf_counter() + 30
        if gov is not None:
            while gov.grade < 3 and time.perf_counter() < steady \
                    and not flood.done():
                await asyncio.sleep(poll_s)
            while time.perf_counter() < steady and not flood.done():
                if len(b._queue) <= 64 and b._inflight is not None \
                        and b._inflight.qsize() <= 1:
                    break
                await asyncio.sleep(poll_s)
        else:
            await asyncio.sleep(n * conns / rate / 4)
        node.latency_observatory.reset()
        t_meas = time.perf_counter()
        await flood
        flood_s_real = time.perf_counter() - t0
        # the QoS 1 settle: every accepted QoS 1 PUBLISH delivered
        deadline = time.perf_counter() + O_TIMEOUT_S
        while time.perf_counter() < deadline and got["q1"] < m.val(
                "messages.qos1.received") - before["messages.qos1.received"]:
            await asyncio.sleep(0.05)
        await quiet(lambda: (got["q0"], got["q1"],
                             m.val("messages.qos1.received")))
        settle_s = time.perf_counter() - t0
        launches = dict(D.LAUNCHES)
        scan_shapes = dict(D.LAUNCH_SHAPES["prefix_sum"])
        windows = dict(wins)
        delta = {k: m.val(k) - v for k, v in before.items()}
        snap = node.pipeline_telemetry.snapshot()
        # the recovery at the governor's production step-down
        recovered = gov is None
        if gov is not None:
            gov.down_sustain = 5
            deadline = time.perf_counter() + O_RECOVER_S
            while time.perf_counter() < deadline:
                if gov.grade == 0 and not gov._armed:
                    recovered = True
                    break
                await asyncio.sleep(poll_s)
        recover_s = time.perf_counter() - t0 - settle_s
        node.stop_timers()
        # two windows of the flood's own topic sequence held against the
        # plain path: a fused window of the mix (16 unique topics: the
        # dedup plan) and one QoS 1 row from each connection, what a
        # window holds while QoS 0 is shed
        qos = [int(i % O_QOS1_EVERY == O_QOS1_EVERY - 1)
               for i in range(b.max_batch)]
        hold_err = hold_window(
            eng, [[make("cmp", q, f"ov/q{q}/t{i % O_TOPICS}", b"")
                   for i, q in enumerate(qos)] for _ in range(2)],
            "overload window", True)
        hold_err = max(hold_err, hold_window(
            eng, [[make("cmp", 1, f"ov/q1/t{i % O_TOPICS}", b"")
                   for i in range(conns)]], "overload QoS 1 window", False))
    finally:
        for t in (drainer, *sinks, *tasks):
            t.cancel()
        for _r, w in pairs:
            w.close()
        await sub.close()
        await lst.stop()
        await node.publish_batcher.stop()
        node.publish_batcher.close()
    lat = snap.get("latency") or {}
    q1_routed = {k: v["p99_ms"] for k, v in (lat.get("routed") or {}).items()
                 if k.startswith("q1.")}
    return {"governor": bool(governor), "conns": conns,
            "warm_msgs_per_s": round(warm_rate), "rate": round(rate),
            "msgs_per_conn": n, "cut_from": n_msgs,
            "flood_s": flood_s_real, "settle_s": settle_s,
            "recover_s": recover_s, "measured_from_s": t_meas - t0,
            "qos1_sent": q1_sent,
            "qos1_received": delta["messages.qos1.received"],
            "qos1_delivered": got["q1"], "qos0_sent": conns * n - q1_sent,
            "qos0_delivered": got["q0"],
            "accepted": delta["messages.publish"],
            "qos0_shed": m.val("pipeline.overload.qos0_shed"),
            "disconnects": m.val("pipeline.overload.disconnects"),
            "order_violations": got["order"],
            "routed_p99_ms": (lat.get("slo") or {}).get("routed_p99_ms"),
            "q1_routed_p99_ms": q1_routed,
            "objective_p99_ms": lat.get("objective_p99_ms"),
            "verdict": (lat.get("slo") or {}).get("verdict"),
            "timeline": timeline, "recovered": recovered,
            "overload": snap.get("overload"), "windows": windows,
            # of the windows the chooser may send to the device
            "window_share": windows["device"] / max(
                1, windows["device"] + windows["host"]),
            "device_share": delta["routing.device.messages"] / max(
                1, delta["routing.device.messages"]
                + delta["routing.host.messages"]),
            "launches": launches, "hold_err": hold_err,
            "scan_shapes": [[list(k), v] for k, v in scan_shapes.items()],
            "supervise": check_supervised(
                node, f"phase 12 governor {'on' if governor else 'off'}"),
            "device": str(dev)}


def overload_one(dev, governor: bool, rate=None, conns: int = O_CONNS,
                 n_msgs: int = O_MSGS, warm_msgs: int = O_WARM_MSGS,
                 flood_s: float = O_FLOOD_S) -> dict:
    """One phase-12 twin in this process (``--overload`` runs it in a
    child of its own on the card)."""
    import asyncio

    import torch
    return asyncio.run(_overload_run(torch.device(dev), governor, rate,
                                     conns, n_msgs, warm_msgs, flood_s))


def check_overload_pair(on: dict, off: dict, cuda: bool) -> None:
    """Both twins deliver every accepted QoS 1 PUBLISH in per-publisher
    order; only the governed one sheds, only QoS 0; it recovers to
    normal with nothing armed; both run the kernels and route at least
    E2E_MIN_DEVICE_SHARE of their messages, and of their windows of at
    least device_min_batch rows, on the device. (Each twin's windows
    held against the plain path raised in its run if they disagreed.)"""
    for r in (on, off):
        name = f"phase 12 governor {'on' if r['governor'] else 'off'}"
        if r["qos1_delivered"] != r["qos1_received"]:
            raise AssertionError(f"{name}: {r['qos1_delivered']} of "
                                 f"{r['qos1_received']} accepted QoS 1 "
                                 f"PUBLISHes delivered")
        if r["order_violations"]:
            raise AssertionError(f"{name}: {r['order_violations']} QoS 1 "
                                 f"deliveries out of publisher order")
        # by messages, as phases 8 and 11 count it, and by the windows
        # the chooser decides: while QoS 0 is shed the governed twin's
        # windows are the QoS 1 rows alone, and those under
        # device_min_batch go to the host by rule, whatever it says
        if r["device_share"] < E2E_MIN_DEVICE_SHARE:
            raise AssertionError(f"{name}: {r['device_share']:.3f} of the "
                                 f"messages routed on the device")
        if r["window_share"] < E2E_MIN_DEVICE_SHARE:
            raise AssertionError(f"{name}: {r['window_share']:.3f} of the "
                                 f"windows of at least device_min_batch "
                                 f"rows on the device: {r['windows']}")
        if cuda and (r["launches"]["shape_match"] == 0
                     or r["launches"]["prefix_sum"] == 0):
            raise AssertionError(f"{name}: a kernel was not launched: "
                                 f"{r['launches']}")
    if on["qos0_shed"] <= 0:
        raise AssertionError("phase 12: the governed twin shed no QoS 0")
    if off["qos0_shed"] != 0:
        raise AssertionError("phase 12: the ungoverned twin shed")
    if not on["recovered"]:
        raise AssertionError(f"phase 12: the governor did not recover: "
                             f"{on['overload']}")


def overload_phase(card: str, kids=None) -> dict:
    """Phase 12 on the card: the governed twin first (its warm pass sets
    the paced rate), then the ungoverned one at the same rate, each in a
    process of its own (`kids`: the two, started ahead)."""
    t0 = time.time()
    rows = {}
    rate = None
    kids = kids or [_Child("--overload"), _Child("--overload")]
    for governor, kid in zip((True, False), kids):
        arg = json.dumps({"governor": governor, "rate": rate})
        rc, out, err = kid.run(arg, O_ONE_TIMEOUT_S)
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if rc != 0 or not lines:
            raise AssertionError(
                f"phase 12 governor {governor}: the child failed, rc "
                f"{rc}: {err[-2000:]}")
        r = rows[governor] = json.loads(lines[-1])
        rate = r["rate"]
        log(f"phase 12 governor {'on' if governor else 'off'}: warm pass "
            f"{r['warm_msgs_per_s']} msgs/s; paced flood at {r['rate']} "
            f"msgs/s, {r['conns']} x {r['msgs_per_conn']} PUBLISHes (cut "
            f"from {r['cut_from']} a connection to fit {O_FLOOD_S:.0f} s) "
            f"in {r['flood_s']:.2f} s, settled at {r['settle_s']:.2f} s; "
            f"accepted {r['accepted']}; QoS 1 sent / accepted / delivered "
            f"{r['qos1_sent']} / {r['qos1_received']} / "
            f"{r['qos1_delivered']}; QoS 0 sent / shed / delivered "
            f"{r['qos0_sent']} / {r['qos0_shed']} / {r['qos0_delivered']}; "
            f"{r['disconnects']} offender disconnects; messages on the "
            f"device {r['device_share']:.3f}, windows of at least "
            f"device_min_batch rows {r['window_share']:.3f} (windows "
            f"{json.dumps(r['windows'])}); launches {r['launches']}; kernel "
            f"2 launches by shape "
            f"{json.dumps({str(tuple(k)): v for k, v in r['scan_shapes']})}"
            f"; two windows of the flood's topics == plain path (max "
            f"|diff| {r['hold_err']})")
        log(f"phase 12 governor {'on' if governor else 'off'}: grade "
            f"timeline (s, grade) {json.dumps(r['timeline'])}; recovered "
            f"to normal {r['recovered']} ({r['recover_s']:.2f} s after the "
            f"settle); routed p99 {r['routed_p99_ms']} ms, QoS 1 routed "
            f"p99 {json.dumps(r['q1_routed_p99_ms'])} ms, objective "
            f"{r['objective_p99_ms']} ms ({r['verdict']}; recorded, not "
            f"asserted), measured from {r['measured_from_s']:.2f} s; "
            f"overload {json.dumps(r['overload'])}; supervisor noted "
            f"{json.dumps(r['supervise'])}")
    check_overload_pair(rows[True], rows[False], cuda=True)
    log(f"phase 12: both twins delivered every accepted QoS 1 PUBLISH in "
        f"publisher order; only the governed twin shed ({rows[True]['qos0_shed']} "
        f"QoS 0) and it recovered to normal; routed p99 on / off "
        f"{rows[True]['routed_p99_ms']} / {rows[False]['routed_p99_ms']} ms "
        f"against {O_SLO_MS} ms; {time.time() - t0:.1f} s")
    log(card)
    return {"on": rows[True], "off": rows[False]}




# ---- phase 13: chaos on the card ------------------------------------------

# phase 13a on a card: the CPU node's cells run in these processes beside
# the card's, which run in this one
CHAOS_CPU_WORKERS = 4


def _cpu_worker() -> None:
    import torch
    torch.set_num_threads(1)


def _cpu_twin(delta: bool) -> dict:
    from emqx_tpu_torch import chaos as C
    return C.run_twin(delta=delta, device="cpu")


def _cpu_case(point: str, kind: str) -> dict:
    from emqx_tpu_torch import chaos as C
    return C.run_case(point, kind, device="cpu")


def chaos_matrix(dev) -> dict:
    """Phase 13a: the 24 cells of ``emqx_tpu_torch.chaos`` (every pipeline
    injection point x every fault kind) at ``tools/chaos_bench.py``'s size
    on a node on `dev`, with the bench's tuning (threshold 1, cooldown
    0.05 s, watchdog floor 0.1 s, multiplier 0), each graded by the
    chaos oracle against the fault-free twin on `dev`, and its scheduled
    deliveries held equal to the same cell's on the port's CPU node (on a
    card, the CPU cells run in CHAOS_CPU_WORKERS processes of their own
    meanwhile). The launch counters are set to 0 before the matrix and
    read after it. Returns the cells' numbers; raises on any
    violation."""
    import concurrent.futures as cf
    import multiprocessing as mp
    # the run's heap so far frozen: the collection after each cell scans
    # only what the cells made
    gc.collect()
    gc.freeze()
    pool = cf.ProcessPoolExecutor(
        CHAOS_CPU_WORKERS, mp_context=mp.get_context("spawn"),
        initializer=_cpu_worker) if dev.type == "cuda" else None
    try:
        return _chaos_cells(dev, pool)
    finally:
        gc.unfreeze()
        if pool is not None:
            pool.shutdown(cancel_futures=True)


def _chaos_cells(dev, pool) -> dict:
    """chaos_matrix's cells; the CPU node's run in `pool` when given."""
    import torch

    from emqx_tpu_torch import chaos as C
    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.supervise import FAULT_KINDS

    def on_cpu(fn, *a):
        return pool.submit(fn, *a) if pool else fn(*a)

    def got(x):
        return x.result() if pool else x
    cpu_twins = {d: on_cpu(_cpu_twin, d) for d in (False, True)}
    cpu_cases = {(point, kind): on_cpu(_cpu_case, point, kind)
                 for point in C.MATRIX_POINTS for kind in FAULT_KINDS}
    twins = {d: C.run_twin(delta=d, device=dev) for d in (False, True)}
    cpu_twins = {d: got(t) for d, t in cpu_twins.items()}
    for d in (False, True):
        if C.scheduled(twins[d], twins[d]) \
                != C.scheduled(cpu_twins[d], cpu_twins[d]):
            raise AssertionError(f"phase 13a: the fault-free twins (delta "
                                 f"{d}) deliver differently on {dev} and "
                                 f"on the CPU")
        if not twins[d]["device_batches"]:
            raise AssertionError("phase 13a: the twin ran no device window")
    D.reset_launches()
    cells, probes, bad = {}, {}, []
    for point in C.MATRIX_POINTS:
        for kind in FAULT_KINDS:
            t0 = time.time()
            c = C.run_case(point, kind, device=dev)
            sec = time.time() - t0
            cpu = got(cpu_cases[(point, kind)])
            twin, cpu_twin = twins[point == "overlay_apply"], \
                cpu_twins[point == "overlay_apply"]
            v = C.grade(c, twin, point, kind)
            v += [f"cpu: {x}" for x in C.grade(cpu, cpu_twin, point, kind)]
            if C.scheduled(c, twin) != C.scheduled(cpu, cpu_twin):
                v.append("scheduled deliveries differ from the CPU node's")
            if c["eager_windows"]:
                # every window, the rung-1 plain ones included, replays a
                # class the warm-up captured: none is captured or run
                # eagerly on the serving path
                v.append(f"{c['eager_windows']} eager windows")
            for k, n in c["probe_launches"].items():
                probes[k] = probes.get(k, 0) + n
            cells[f"{point}:{kind}"] = {
                k: c[k] for k in ("faults", "trips", "replays", "stalls",
                                  "probes", "rung_changes",
                                  "device_batches", "eager_windows")}
            cells[f"{point}:{kind}"]["s"] = round(sec, 3)
            bad += [f"{point}:{kind}: {x}" for x in v]
            gc.collect()
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 13a: " + "; ".join(bad))
    return {"cells": cells, "launches": dict(D.LAUNCHES),
            "probe_launches": probes}


def chaos_fatal(dev) -> dict:
    """Phase 13d: on the card's rules, a non-injected RuntimeError raised
    inside one dispatch reaches the window's publishers and sets
    ``engine.failed`` (no replay), while an InjectedFault raised in the
    same place replays its window on the host. A real out of memory in
    the dispatch and a real stall of the readback past the watchdog fail
    as the RuntimeError does, and the stalled window's pins are released
    when its thread leaves."""
    import torch

    from emqx_tpu_torch import chaos as C
    from emqx_tpu_torch.broker.supervise import InjectedFault
    node, out = C.fatal_drive(lambda eng, sup: C.raise_once(
        eng, "_dispatch_inner", RuntimeError("not injected")), device=dev)
    real = {"first_window": sorted({type(c).__name__ for c in out[0]}),
            "failed": repr(node.device_engine.failed),
            "replays": node.metrics.val("supervise.replays"),
            "later_windows_raised": all(isinstance(c, RuntimeError)
                                        for w in out[1:] for c in w)}
    if not (all(isinstance(c, RuntimeError) for c in out[0])
            and "not injected" in {str(c) for c in out[0]}
            and str(node.device_engine.failed) == "not injected"
            and real["replays"] == 0 and real["later_windows_raised"]):
        raise AssertionError(f"phase 13d: a real dispatch error did not "
                             f"raise to the publishers and fail the "
                             f"engine: {real}")
    node, out = C.fatal_drive(lambda eng, sup: C.raise_once(
        eng, "_dispatch_inner", InjectedFault("injected")), device=dev)
    inj = {"counts": sorted({c for w in out for c in w}, key=str),
           "failed": repr(node.device_engine.failed),
           "replays": node.metrics.val("supervise.replays")}
    if inj["counts"] != [2] or node.device_engine.failed is not None \
            or inj["replays"] != 1:
        raise AssertionError(f"phase 13d: an injected dispatch fault did "
                             f"not replay: {inj}")
    # a real out of memory in the dispatch and a real stall of the
    # readback past the watchdog (no clause armed) fail like the error
    oom, stall = (
        (lambda eng, sup: C.raise_once(
            eng, "_dispatch_inner", torch.cuda.OutOfMemoryError("real"))),
        (lambda eng, sup: C.stall_once(eng, "_materialize",
                                       3 * C.WATCHDOG_FLOOR_S)))
    fatal = {}
    for name, arm, want in (("oom", oom, torch.cuda.OutOfMemoryError),
                            ("stall", stall, TimeoutError)):
        node, out = C.fatal_drive(arm, device=dev)
        f = {"first_window": sorted({type(c).__name__ for c in out[0]}),
             "failed": repr(node.device_engine.failed),
             "replays": node.metrics.val("supervise.replays"),
             "journal": node.supervisor.journal_depth(),
             "pins": node.hbm_ledger.pin_state()["outstanding"]}
        if not (all(isinstance(c, want) for c in out[0])
                and isinstance(node.device_engine.failed, want)
                and f["replays"] == 0 and f["journal"] == 0
                and f["pins"] == 0):
            raise AssertionError(f"phase 13d: a real {name} did not raise "
                                 f"to the publishers and fail the engine: "
                                 f"{f}")
        fatal[name] = f
    return {"real_error": real, "injected": inj, **fatal}


def chaos_phase(card: str, probes_13b: dict) -> dict:
    """Phase 13 on the card (13b runs inside phase 8, on its node):
    the matrix, the probes' kernels and the fatal departure."""
    import torch
    t0 = time.time()
    dev = torch.device("cuda")
    m = chaos_matrix(dev)
    for k, c in m["cells"].items():
        log(f"phase 13a {k}: {json.dumps(c)}")
    log(f"phase 13a: 24 of 24 cells green on {dev} (graded against the "
        f"card's fault-free twin: equal counts and per-session order, a "
        f"trip within the window, stalls for hangs at dispatch/materialize"
        f", replays for raising kinds there, rung 0 again, journal and "
        f"ledger pins 0), each equal to the same cell on the port's CPU "
        f"node; launches over the matrix {m['launches']}")
    probes = {k: m["probe_launches"].get(k, 0) + probes_13b.get(k, 0)
              for k in ("shape_match", "prefix_sum")}
    if not all(probes.values()):
        raise AssertionError(f"phase 13c: the probes launched {probes}")
    log(f"phase 13c: the half-open dispatch probes launched {probes} "
        f"(matrix {m['probe_launches']}, phase 13b {probes_13b})")
    f = chaos_fatal(dev)
    log(f"phase 13d: a RuntimeError raised in one dispatch reached the "
        f"publishers and failed the engine {json.dumps(f['real_error'])}; "
        f"an InjectedFault in the same place replayed "
        f"{json.dumps(f['injected'])}; a real out of memory there "
        f"{json.dumps(f['oom'])} and a real readback stall past the "
        f"watchdog {json.dumps(f['stall'])} raised and failed the engine "
        f"too")
    log(f"phase 13 {time.time() - t0:.1f} s")
    log(card)
    return {"matrix": m, "probes": probes, "fatal": f}


# ---- phase 14: the mesh serving under Node ---------------------------------
# 14a: tools/sharded_bench.py's drive at its size (SHARDED_r05.json): the
# filters dev/d{i}/+/n{n}/# (99,856) over dp=2 x route=4, max_batch 128,
# oracle-checked batches through the pipelined dispatch, single-shard
# churn while serving, and a shared-slot burst that outgrows its class
# with host serving during the background rebuild
MN_DEVICES, MN_DP = 8, 2
MN_FILTERS = PART_FILTERS     # 100,000 before QUIC
MN_BATCH = 128
MN_BATCHES = 40
MN_CHURN_ROUNDS = 2          # x 32 subscribes (10 before phase 20, 4
                             # before QUIC)
MN_MSGS = 8_000              # 14b's flood (16,000 before QUIC)
MN_WARM_TRIES = 5            # tools/sharded_bench.py:127-140
# 14b: phase 8's population and flood through a multichip node (max_batch
# 256, the reference's default); 14c: one counted mesh_exchange fault in a
# flood of MN_FAULT_MSGS on the same node
MN_FAULT_MSGS = 4_000
MN_FAULT_AFTER = 5
# the single-chip engine's incremental capture at phase 8's population:
# the filters churned between the two captures
CAPTURE_CHURN = 512
CAPTURE_PAIRS = 3            # full / incremental captures of one state
                             # (5 before QUIC)


class _Count:
    """A session that counts its deliveries."""

    def __init__(self):
        self.n = 0

    def deliver(self, topic_filter, msg):
        self.n += 1
        return True


def _mesh_topics(r, ids: int, nums: int, n: int) -> list:
    return [f"dev/d{i}/x/n{k}/t" for i, k in zip(r.randint(0, ids, n),
                                                 r.randint(0, nums, n))]


def _warm_mesh_exchange(eng, make, topics_fn, B: int, metrics) -> None:
    """tools/sharded_bench.py:127-140: warm the exchange class of a
    B-wide window and let the EWMA ladder adapt on flood-shaped traffic
    (a cold or undersized class gathers)."""
    for _ in range(MN_WARM_TRIES):
        before = metrics.val("pipeline.exchange.windows")
        eng.warm_exchange(B)
        eng.route_batch([make("w", 0, t, b"") for t in topics_fn(B)],
                        wait=True)
        if metrics.val("pipeline.exchange.windows") > before:
            break


def hold_mesh_window(eng, topics: list, what: str) -> int:
    """One mesh window of `topics` held against the plain path on the
    same device: the sharded step's planes (kernel 2 against
    prefix_sum_ref), the exchange (kernels 2 and 3 against their plain
    versions) and the gather's CSR compaction (kernel 2), bit for bit.
    Nothing is delivered. Returns max |diff| (0)."""
    import torch

    from emqx_tpu_torch.ops.compact import compact_result
    from emqx_tpu_torch.ops.exchange import ring_rotate_ref
    from emqx_tpu_torch.ops.match import encode_topics_str
    from emqx_tpu_torch.ops.scan import prefix_sum_ref
    from emqx_tpu_torch.ops.shared import STRATEGIES
    from emqx_tpu_torch.parallel.sharded import (make_exchange_step,
                                                 make_sharded_route_step)
    B = eng._batch_class(len(topics))
    enc, lens, dollar, _tl = encode_topics_str(eng.intern, topics,
                                               eng.level_cap)
    mh = np.array([zlib.crc32(t.encode()) & 0x7FFFFFFF for t in topics],
                  np.int32)
    ins = eng._enc_tensors(enc[:B], lens[:B], dollar[:B], mh[:B])
    strat = STRATEGIES[eng.broker.shared_strategy]
    with eng._lock:
        tables, cur, aux = eng.tables, eng.cursors.clone(), eng.aux
    with eng._cuda_lock:
        res_k = eng.step(tables, cur, *ins, strat)
        plain = make_sharded_route_step(
            eng.mesh, scan=prefix_sum_ref, frontier_cap=eng.frontier_cap,
            match_cap=eng.match_cap, fanout_cap=eng.fanout_cap,
            slot_cap=eng.slot_cap)
        res_p = plain(tables, cur, *ins, strat)
        err = 0
        for name in res_k._fields:
            err = max(err, exact(getattr(res_k, name), getattr(res_p, name),
                                 f"{what} step {name}"))
        E = eng._choose_ecap(B)
        planes = (res_k.matches, res_k.rows, res_k.opts, res_k.shared_sids,
                  res_k.overflow)
        ex_k = eng.exchange_step(E)(*planes, aux)
        ex_p = make_exchange_step(eng.mesh, seg_cap=E, scan=prefix_sum_ref,
                                  rotate=ring_rotate_ref)(*planes, aux)
        for name in ex_k._fields:
            err = max(err, exact(getattr(ex_k, name), getattr(ex_p, name),
                                 f"{what} exchange {name}"))
        P = eng._choose_pcap(B) or 32 * B
        cp_k = eng._compact(res_k, P)
        Bk, R = res_k.matches.shape[:2]

        def flat(x):
            return x.reshape((1, Bk * R) + tuple(x.shape[2:]))

        cp_p = compact_result(
            *(flat(getattr(res_k, k)) for k in (
                "matches", "rows", "opts", "fan_counts", "shared_sids",
                "shared_rows", "shared_opts")),
            payload_cap=P, match_holes=False, scan=prefix_sum_ref)
        for name in cp_k._fields:
            err = max(err, exact(getattr(cp_k, name), getattr(cp_p, name),
                                 f"{what} compact {name}"))
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
    return err


def mesh_sharded_drive(dev, n_filters: int = MN_FILTERS,
                       batch: int = MN_BATCH, batches: int = MN_BATCHES,
                       churn_rounds: int = MN_CHURN_ROUNDS,
                       seed: int = SEED) -> dict:
    """Phase 14a: tools/sharded_bench.py's drive on the port's multichip
    node (no sockets): the population with one counting session per
    filter, the full build, the exchange warm-up, `batches` windows of
    `batch` flood topics through the pipelined dispatch (one dispatch
    thread, one readback thread, the node's depth in flight, settle in
    order) each checked against the oracle (one delivery a message), a
    window held against the plain path, churn_rounds x 32 subscribes
    each served at once (the dirty shards update before the window), and
    a shared-slot burst on one filter that outgrows its capacity class:
    windows route on the host while the background full build runs, and
    not one delivery is lost across it. Raises on any failed check."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    node = Node({"broker": {"multichip": {
        "enable": True, "devices": MN_DEVICES, "dp": MN_DP,
        "max_batch": batch}, "deliver_lanes": 0}}, device=dev)
    b, eng, m = node.broker, node.device_engine, node.metrics
    ids, nums = e2e_grid(n_filters)
    out = {"filters": ids * nums, "batch": batch,
           "mesh": {"dp": eng.n_dp, "route": eng.n_route}}
    t0 = time.time()
    for i in range(ids):
        for n in range(nums):
            b.subscribe(b.register(_Count(), f"s{i}-{n}"),
                        f"dev/d{i}/+/n{n}/#")
    out["subscribe_s"] = time.time() - t0
    t0 = time.time()
    eng.rebuild()
    out["build_s"] = time.time() - t0
    out["caps"] = dict(eng._caps)
    r = np.random.RandomState(seed)
    eng.route_batch([make("p", 0, "dev/d0/x/n0/t", b"")] * batch, wait=True)
    _warm_mesh_exchange(eng, make, lambda n: _mesh_topics(r, ids, nums, n),
                        batch, m)
    out["exchange_warm"] = {"classes": sorted(eng._exch_warm),
                            "ewma": eng._exch_ewma}
    depth = eng.dispatch_depth
    x0 = {k: m.val(k) for k in ("pipeline.exchange.windows",
                                "pipeline.readback.windows.compact",
                                "pipeline.readback.windows.dense")}
    disp = ThreadPoolExecutor(1, thread_name_prefix="mesh-disp")
    read = ThreadPoolExecutor(1, thread_name_prefix="mesh-read")
    inflight: deque = deque()
    routed = 0

    def settle(rec):
        nonlocal routed
        bi, h, fut = rec
        fut.result().result()
        counts = eng.finish(h)
        if counts != [1] * batch:
            raise AssertionError(f"phase 14a batch {bi}: {counts[:8]}...")
        routed += batch

    D.reset_launches()
    t0 = time.time()
    try:
        for bi in range(batches):
            msgs = [make("p", 0, t, b"x")
                    for t in _mesh_topics(r, ids, nums, batch)]
            while len(inflight) >= depth:
                settle(inflight.popleft())
            h = eng.prepare(msgs)
            if h is None:
                raise AssertionError(f"phase 14a: the mesh stood down at "
                                     f"batch {bi}")

            def stages(h=h):
                eng.dispatch(h)
                return read.submit(eng.materialize, h)

            inflight.append((bi, h, disp.submit(stages)))
        while inflight:
            settle(inflight.popleft())
        dt = time.time() - t0
    finally:
        disp.shutdown(wait=True)
        read.shutdown(wait=True)
    out["launches"] = dict(D.LAUNCHES)
    out["flood"] = {"msgs": routed, "per_s": routed / dt, "wall_s": dt,
                    "dispatch_depth": depth,
                    **{k.rsplit(".", 2)[-2] + "_" + k.rsplit(".", 1)[-1]:
                       m.val(k) - v for k, v in x0.items()}}
    out["window_err"] = hold_mesh_window(
        eng, _mesh_topics(r, ids, nums, batch), "phase 14a window")

    t0 = time.time()
    u0 = m.val("routing.mesh.shard_updates")
    for rnd in range(churn_rounds):
        for k in range(32):
            b.subscribe(b.register(_Count(), f"ch{rnd}-{k}"),
                        f"churn/r{rnd}/k{k}/+")
        if not eng.dirty_shards:
            raise AssertionError("phase 14a: churn dirtied no shard")
        msgs = [make("p", 0, f"churn/r{rnd}/k{k}/z", b"y")
                for k in range(min(32, batch))]
        counts = eng.route_batch(msgs, wait=True)
        if counts != [1] * len(msgs) or eng.dirty_shards:
            raise AssertionError(f"phase 14a churn round {rnd}: "
                                 f"{counts[:8]}, dirty {eng.dirty_shards}")
    out["churn"] = {"rounds": churn_rounds,
                    "shard_updates": m.val("routing.mesh.shard_updates") - u0,
                    "wall_s": time.time() - t0}

    t0 = time.time()
    caps_before = dict(eng._caps)
    n_groups = int(caps_before["slots"]) + 2
    grow = []
    for k in range(n_groups):
        c = _Count()
        grow.append(c)
        b.subscribe(b.register(c, f"g{k}"), f"$share/g{k}/grow/hot/topic")
    host_served = mesh_served = 0
    h0 = m.val("routing.mesh.rebuild_host")
    deadline = time.time() + 300
    while time.time() < deadline:
        msgs = [make("p", 0, "grow/hot/topic", b"z")]
        counts = eng.route_batch(msgs)
        if counts is None:
            # the mesh rebuilds: the node's path routes on the host
            b._route(msgs[0], b.router.match(msgs[0].topic))
            host_served += 1
            time.sleep(0.01)
            continue
        if counts != [n_groups]:
            raise AssertionError(f"phase 14a overflow: {counts}")
        mesh_served += 1
        if eng._caps["slots"] > caps_before["slots"] and mesh_served >= 3:
            break
    if eng._caps["slots"] <= caps_before["slots"]:
        raise AssertionError(f"phase 14a: the slots class never grew "
                             f"{caps_before} -> {eng._caps}")
    got = sum(c.n for c in grow)
    want = (host_served + mesh_served) * n_groups
    if got != want:
        raise AssertionError(f"phase 14a: deliveries lost across the "
                             f"capacity rebuild: {got} != {want}")
    if m.val("routing.mesh.rebuild_host") - h0 != host_served:
        raise AssertionError("phase 14a: host-served windows not counted")
    out["overflow"] = {"slots_cap": [caps_before["slots"],
                                     eng._caps["slots"]],
                       "host_served_during_rebuild": host_served,
                       "mesh_served_after": mesh_served,
                       "wall_s": time.time() - t0}
    out["stats"] = eng.stats()
    eng.close()
    if eng.failed is not None:
        raise AssertionError(f"phase 14a: the server failed: "
                             f"{eng.failed!r}")
    return out


def mesh_fatal_check(dev) -> dict:
    """A real failure on the mesh raises (phase 14c's second half): the
    step raising a plain RuntimeError once on a small supervised mesh
    node is not replayed — route_batch raises it, the server keeps it
    (``failed``) and the next window raises too."""
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.chaos import raise_once
    node = Node({"broker": {"multichip": {
        "enable": True, "devices": MN_DEVICES, "dp": MN_DP,
        "max_batch": 16}, "deliver_lanes": 0}}, device=dev)
    b, eng = node.broker, node.device_engine
    eng.fail_on_device_error = True     # the card's rule (on the CPU too)
    for i in range(64):
        b.subscribe(b.register(_Count(), f"f{i}"), f"fatal/{i}/+")
    if eng.route_batch([make("p", 0, "fatal/1/x", b"")], wait=True) != [1]:
        raise AssertionError("phase 14c: the small mesh node did not route")
    eng.close()             # no warm-up thread may take the failure first
    raise_once(eng, "step", RuntimeError("mesh kernel broke"))
    out = {}
    for k in ("first", "next"):
        try:
            eng.route_batch([make("p", 0, "fatal/2/x", b"")], wait=True)
        except RuntimeError as e:
            out[k] = str(e)
        else:
            raise AssertionError(f"phase 14c: the {k} window after a real "
                                 f"failure did not raise")
    eng.close()
    if eng.failed is None or node.metrics.val("supervise.replays"):
        raise AssertionError("phase 14c: a real failure was replayed")
    return out


def mesh_node_drive(dev, n_filters: int = PART_FILTERS,
                    n_sub: int = E2E_SUB_CONNS, n_pub: int = E2E_PUB_CONNS,
                    total: int = MN_MSGS, fault_msgs: int = MN_FAULT_MSGS,
                    fault_after: int = MN_FAULT_AFTER,
                    seed: int = SEED) -> dict:
    """Phases 14b and 14c: a multichip node (dp=2 x route=4 shards on the
    card, the reference's max_batch 256, the reference's defaults: lanes,
    ledger, supervision, recorder, observatory, governor) over live TCP
    with phase 8's population and flood (``_flood``: every message
    delivered once, in per-session publisher order per topic, to a
    connection that holds its filter). The batcher's chooser is held on the device (the
    path under test). Then 14c on the same node: one mesh_exchange fault
    armed mid-flood (breaker threshold 1, cooldown 0.05 s): it must trip,
    replay on the host, and return to rung 0; every message still once.
    Raises on any failed check."""
    import asyncio

    async def run():
        import torch

        from emqx_tpu_torch import device as D
        from emqx_tpu_torch.broker.connection import Listener
        from emqx_tpu_torch.broker.message import make
        from emqx_tpu_torch.broker.node import Node
        from emqx_tpu_torch.broker.supervise import (FaultInjector,
                                                     parse_faults)
        from emqx_tpu_torch.client import Client
        alloc0 = torch.cuda.memory_allocated(dev) \
            if dev.type == "cuda" else None
        node = Node({"broker": {"multichip": {
            "enable": True, "devices": MN_DEVICES, "dp": MN_DP},
            "dispatch_depth": 2}}, device=dev)
        eng, m, sup = node.device_engine, node.metrics, node.supervisor
        node.publish_batcher._device_worth_it = lambda: True
        lst = Listener(node, bind="127.0.0.1", port=0)
        await lst.start()
        clients = []
        try:
            t0 = time.time()
            subs, ids, nums, n_shared, n_entries = \
                await _subscribe_population(lst.port, n_filters, n_sub)
            clients += subs
            out = {"filters": ids * nums, "shared_filters": n_shared,
                   "subscriptions": n_entries,
                   "subscribe_s": time.time() - t0,
                   "max_batch": node.publish_batcher.max_batch}
            for c in range(n_pub):
                cl = Client(port=lst.port, clientid=f"epub{c}")
                await cl.connect()
                clients.append(cl)
            pubs = clients[n_sub:]
            t0 = time.time()
            eng.route_batch([make("w", 0, "warmup/none/t", b"")], wait=True)
            out["build_s"] = time.time() - t0
            Bp = eng.n_dp
            while Bp <= eng.max_batch:
                eng._warm_one(Bp)
                Bp *= 2
            r = np.random.RandomState(seed)
            topics = lambda n: [f"device/d{i}/x/n{k}/t" for i, k in zip(
                r.randint(0, ids, n), r.randint(0, nums, n))]
            _warm_mesh_exchange(eng, make, topics, eng.max_batch, m)
            Bp = eng.n_dp
            while Bp < eng.max_batch:
                eng.warm_exchange(Bp)
                Bp *= 2
            out["warm_up_s"] = time.time() - t0
            # the warm-up's deliveries reach the subscribers: drain them
            # before the flood's drainers start
            last = -1
            while True:
                await asyncio.sleep(0.2)
                n = sum(cl.messages.qsize() for cl in subs)
                if n == last:
                    break
                last = n
            for cl in subs:
                while not cl.messages.empty():
                    cl.messages.get_nowait()
            out["window_err"] = hold_mesh_window(
                eng, topics(eng.max_batch), "phase 14b window")
            gc.collect()
            gc.freeze()
            tele0 = tele_state(node)
            x0 = {k: v for k, v in m.all().items()
                  if k.startswith("pipeline.exchange.")}
            f = await _flood(node, subs, pubs, ids, nums, total, seed + 7,
                             per_topic=True)
            f.pop("got")
            out["scan_shapes"] = dict(D.LAUNCH_SHAPES["prefix_sum"])
            f["telemetry"] = tele_delta(node, tele0)
            f["exchange"] = {k: v - x0.get(k, 0) for k, v in m.all().items()
                             if k.startswith("pipeline.exchange.")
                             and v - x0.get(k, 0)}
            f["device_share"] = f["device_routed"] / f["sent"]
            if dev.type == "cuda" and (f["launches"]["prefix_sum"] == 0
                                       or f["launches"]["ring_rotate"]
                                       == 0):
                raise AssertionError(f"phase 14b: a kernel was not "
                                     f"launched: {f['launches']}")
            if f["batches"] <= 0 or f["device_share"] < \
                    E2E_MIN_DEVICE_SHARE:
                raise AssertionError(f"phase 14b: {f['device_share']:.3f} "
                                     f"of the flood routed by the mesh")
            out["flood"] = f
            out["exchange_section"] = \
                node.pipeline_telemetry.snapshot().get("exchange")
            out["supervise"] = check_supervised(node, "phase 14b")
            out["ledger"] = ledger_line(node, alloc0) \
                if node.hbm_ledger is not None else None

            # 14c: one counted mesh_exchange fault in a flood
            saved = {s: (br.threshold, br.base_cooldown_s)
                     for s, br in sup.breakers.items()}
            for br in sup.breakers.values():
                br.threshold = 1
                br.base_cooldown_s = br.cooldown_s = 0.05
            sup.injector = FaultInjector(parse_faults(
                f"mesh_exchange:exception:after={fault_after}:count=1"))
            times = {}

            async def watch():
                br = sup.breakers["mesh_exchange"]
                while "closed" not in times:
                    now = time.perf_counter()
                    if "fired" not in times and sup.injector.faults[0].fired:
                        times["fired"] = now
                    if "fired" in times and "open" not in times \
                            and br.state != "closed":
                        times["open"] = now
                    if "open" in times and br.state == "closed" \
                            and sup.rung() == 0:
                        times["closed"] = now
                    await asyncio.sleep(0.001)

            w = asyncio.get_running_loop().create_task(watch())
            c = await _flood(node, subs, pubs, ids, nums, fault_msgs,
                             seed + 9, replays=True, per_topic=True)
            c.pop("got")
            for _ in range(2000):
                if "closed" in times:
                    break
                # the breaker's probe rides the windows' poll: tick it
                await asyncio.gather(*[node.publish_async(
                    make("tick", 0, "tick/none", b"")) for _ in range(8)])
                await asyncio.sleep(0.01)
            w.cancel()
            for s, (th, cd) in saved.items():
                sup.breakers[s].threshold = th
                sup.breakers[s].base_cooldown_s = \
                    sup.breakers[s].cooldown_s = cd
            sup.injector = FaultInjector()
            if "closed" not in times:
                raise AssertionError(f"phase 14c: the breaker did not "
                                     f"trip and re-close: {times}, "
                                     f"{sup.state()}")
            out["fault"] = {
                "msgs": c["sent"], "delivered": c["delivered"],
                "per_sec": c["per_sec"],
                "faults": m.val("supervise.faults.mesh_exchange"),
                "replays": m.val("supervise.replays"),
                "trips": m.val("supervise.trips"),
                "rung": sup.rung(),
                "trip_s": times["open"] - times["fired"],
                "recover_s": times["closed"] - times["fired"],
                "launches": c["launches"]}
            if out["fault"]["faults"] != 1 or out["fault"]["replays"] < 1:
                raise AssertionError(f"phase 14c: {out['fault']}")
            out["stats"] = eng.stats()
            if eng.failed is not None:
                raise AssertionError(f"phase 14: the server failed: "
                                     f"{eng.failed!r}")
            return out
        finally:
            gc.unfreeze()
            for cl in clients:
                await cl.disconnect()
            await lst.stop()
            await node.publish_batcher.stop()
            node.publish_batcher.close()
            node.device_engine.close()

    return asyncio.run(run())


def capture_drive(dev, n_filters: int = PART_FILTERS,
                  n_sub: int = E2E_SUB_CONNS,
                  churn: int = CAPTURE_CHURN, seed: int = SEED) -> dict:
    """The single-chip engine's incremental capture at phase 8's
    population: a node at the reference's defaults (overlay on), its
    first build (a full capture), windows that advance the shared
    groups' cursors, then `churn` filters churned — a quarter new plain
    filters, a quarter plain filters dropped, a quarter new shared
    members, a quarter members leaving — and the compaction's rebuild,
    which captures incrementally. The rebuild telemetry's capture
    seconds of both builds, and of a full capture of the same state; the
    incremental capture must equal that full capture, and the next
    window must equal the plain path bit for bit."""
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    node = Node({"broker": {"deliver_lanes": 0}}, device=dev)
    eng, b, m = node.device_engine, node.broker, node.metrics
    ids, nums = e2e_grid(n_filters)
    sinks = _populate(node, ids, nums, n_sub)
    sids = list(range(len(sinks)))

    def captured() -> float:
        h = m.histograms().get("pipeline.rebuild.capture.seconds")
        return h.snapshot()["sum"] if h is not None and h.count else 0.0

    eng.rebuild()
    full_s = captured()
    r = np.random.RandomState(seed)
    for _ in range(4):
        eng.route_batch([make("p", 0, "device/d%d/x/n%d/t" % (
            r.randint(0, ids), r.randint(0, nums)), b"") for _ in range(256)])
    q = churn // 4
    for k in range(q):
        b.subscribe(sids[k % n_sub], f"device/d{k % ids}/+/n{nums + k}/#",
                    {"qos": 0})
    plain = [(i, n) for i in range(ids) for n in range(nums)
             if not e2e_shared(i, n, nums)]
    for k in range(q):
        i, n = plain[(k * 7919) % len(plain)]
        b.unsubscribe(i % n_sub, f"device/d{i}/+/n{n}/#")
    shared = [(i, n) for i in range(ids) for n in range(nums)
              if e2e_shared(i, n, nums)]
    for k in range(q):
        i, n = shared[(k * 104729) % len(shared)]
        b.subscribe((i + 2) % n_sub, f"$share/bg/device/d{i}/+/n{n}/#",
                    {"qos": 1})
    for k in range(q):
        i, n = shared[(k * 15485863 + 1) % len(shared)]
        b.unsubscribe(i % n_sub, f"$share/bg/device/d{i}/+/n{n}/#")
    if not eng._can_capture_incremental():
        raise AssertionError("capture: no incremental baseline")
    touched = eng.journal_depth()
    # the two captures of this one state, in turns (each incremental
    # capture from the same baseline and touched set, the first of a
    # pair alternating): host seconds over a few pairs, each after a
    # full collection (no collector debt carried in), each pair compared
    base, marks = eng._last_capture, set(eng._touched)
    inc_t, full_t = [], []

    def timed(fn, into):
        gc.collect()
        t0 = time.perf_counter()
        out = fn()
        into.append(time.perf_counter() - t0)
        return out

    for k in range(CAPTURE_PAIRS):
        eng._last_capture, eng._touched = base, set(marks)
        if k % 2:
            full = timed(eng._capture_state_sync, full_t)
            eng._last_capture, eng._touched = base, set(marks)
            inc = timed(eng._capture_state_incremental, inc_t)
        else:
            inc = timed(eng._capture_state_incremental, inc_t)
            full = timed(eng._capture_state_sync, full_t)
        same = (sorted(inc[0]) == sorted(full[0])
                and sorted(inc[1]) == sorted(full[1])
                and inc[2] == full[2] and inc[3] == full[3])
        if not same:
            raise AssertionError("capture: the incremental capture "
                                 "differs from the full capture")
    eng._last_capture, eng._touched = base, marks
    c0 = captured()
    eng.rebuild()
    inc_s = captured() - c0
    lives = [[make("cmp", 0, "device/d%d/x/n%d/t" % (
        r.randint(0, ids), r.randint(0, nums)), b"") for _ in range(1024)]]
    err = hold_window(eng, lives, "capture window", False)
    return {"filters": ids * nums, "churned": 4 * q, "touched": touched,
            "full_capture_s": full_s, "incremental_capture_s": inc_s,
            "pairs_full_s": full_t, "pairs_incremental_s": inc_t,
            "equal": same, "window_err": err,
            "backend": eng._built.backend}


def mesh_node_phase(dev, card: str) -> dict:
    """Phase 14 on the card (14a, 14b, 14c, and the single-chip engine's
    incremental capture); prints its lines."""
    import torch
    t_all = time.time()
    a = mesh_sharded_drive(dev)
    log(f"phase 14a: {a['filters']} filters dev/d{{i}}/+/n{{n}}/# over "
        f"dp={a['mesh']['dp']} x route={a['mesh']['route']} on {dev}, "
        f"built in {a['build_s']:.2f} s (caps {json.dumps(a['caps'])}); "
        f"exchange warm {json.dumps(a['exchange_warm'])}")
    fl = a["flood"]
    log(f"phase 14a: {MN_BATCHES} oracle-checked batches of {a['batch']} "
        f"through the pipelined dispatch (depth {fl['dispatch_depth']}): "
        f"{fl['msgs']} msgs in {fl['wall_s']:.2f} s = {fl['per_s']:.0f}/s; "
        f"exchange windows {fl['exchange_windows']}, gathered compact "
        f"{fl['windows_compact']}, dense {fl['windows_dense']}; launches "
        f"{json.dumps(a['launches'])}; a window == plain path (step, "
        f"exchange, CSR compaction, exact)")
    log(f"phase 14a churn: {a['churn']['rounds']} rounds x 32 subscribes, "
        f"{a['churn']['shard_updates']} shard updates while serving in "
        f"{a['churn']['wall_s']:.2f} s")
    ov = a["overflow"]
    log(f"phase 14a overflow: slots class {ov['slots_cap'][0]} -> "
        f"{ov['slots_cap'][1]}; {ov['host_served_during_rebuild']} windows "
        f"served on the host during the background rebuild (counted), "
        f"{ov['mesh_served_after']} by the mesh after; no delivery lost; "
        f"{ov['wall_s']:.2f} s")
    log(f"phase 14a: {time.time() - t_all:.1f} s")
    gc.collect()            # 14a's node (its engine refers back to it)
    torch.cuda.empty_cache()
    t0 = time.time()
    r = mesh_node_drive(dev)
    f = r["flood"]
    log(f"phase 14b: {r['filters']} filters ({r['shared_filters']} in "
        f"shared groups) over TCP in {r['subscribe_s']:.1f} s; mesh built "
        f"in {r['build_s']:.2f} s, warm {r['warm_up_s']:.2f} s; batcher "
        f"max_batch {r['max_batch']}; a window == plain path (exact)")
    log(f"phase 14b: {f['sent']} msgs, every one delivered once in "
        f"per-session publisher order: {f['per_sec']} msgs/s, client "
        f"latency p50 {f['lat_p50_ms']:.2f} ms p99 {f['lat_p99_ms']:.2f} "
        f"ms; device share {f['device_share']:.4f} ({f['batches']} mesh "
        f"windows); exchange {json.dumps(f['exchange'])}; launches "
        f"{json.dumps(f['launches'])}")
    log(f"phase 14b telemetry stages: {json.dumps(f['telemetry']['stages'])}")
    log(f"phase 14b exchange section: {json.dumps(r['exchange_section'])}")
    led = r["ledger"]
    log(f"phase 14b HBM ledger: live {led['live_bytes']} bytes by category "
        f"{json.dumps(led['by_category'])}; accounted "
        f"{led['accounted_fraction']} of memory_allocated "
        f"{led['memory_allocated']} ({led['accounted_of_phase']} of the "
        f"bytes allocated since this phase began)")
    fa = r["fault"]
    log(f"phase 14c: mesh_exchange fault after {MN_FAULT_AFTER} traversals "
        f"in a flood of {fa['msgs']}: {fa['faults']} fault, "
        f"{fa['trips']} trip(s), {fa['replays']} replay(s); tripped in "
        f"{fa['trip_s']:.4f} s, rung back to {fa['rung']} in "
        f"{fa['recover_s']:.4f} s; every message delivered once "
        f"({fa['delivered']})")
    fatal = mesh_fatal_check(dev)
    log(f"phase 14c: a real failure raises: {json.dumps(fatal)}")
    log(f"phase 14b/c: {time.time() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    c = capture_drive(dev)
    log(f"phase 14 capture: {c['filters']} filters ({c['backend']}), "
        f"{c['churned']} churned ({c['touched']} touched): rebuild "
        f"capture seconds, the first build (full) "
        f"{c['full_capture_s']:.4f}, the compaction's (incremental) "
        f"{c['incremental_capture_s']:.4f}; {CAPTURE_PAIRS} pairs of the "
        f"same state, the first alternating, each after gc.collect(): full "
        f"{json.dumps([round(x, 4) for x in c['pairs_full_s']])} against "
        f"incremental "
        f"{json.dumps([round(x, 4) for x in c['pairs_incremental_s']])} "
        f"(medians {np.median(c['pairs_full_s']):.4f} / "
        f"{np.median(c['pairs_incremental_s']):.4f}); incremental == full "
        f"every pair; the next window == plain path (exact); "
        f"{time.time() - t0:.1f} s")
    return {"a": a, "b": r, "fatal": fatal, "capture": c,
            "err": max(a["window_err"], r["window_err"], c["window_err"])}


# ---- phase 15: the default node booted from its config file ------------

# the repo's shipped configuration
BOOT_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "etc",
                         "emqx.conf")
BOOT_PUBS = (("tcp", 4), ("ssl", 2), ("ws", 2),    # publishers by
             ("quic", 2))                          # transport
BOOT_QUIC_SUBS = 2                   # 15a's subscriber connections on QUIC
BOOT_MSGS = E2E_MSGS                 # 15a's flood
BOOT_FLOOD_S = 240.0                 # 15a's flood, QUIC included, at most
BOOT_LOSSY_MSGS = 20                 # 15e: QoS 1 through the dropper
BOOT_LOSSY_EVERY = 3                 # 15e: every 3rd datagram dropped
BOOT_BAN_S = 2.0                     # 15b's ban duration
BOOT_SUSTAIN_S = 1                   # conn_congestion's sustain in 15b
BOOT_SLOW_MSGS = 5_000               # 15b's QoS 0 burst to a stalled reader
BOOT_SLOW_PAYLOAD = 8192
BOOT_DENSE_MSGS = 4_000              # 15c's floods, dense and CSR (16,000
                                     # before QUIC)
BOOT_MESH_MSGS = 2_000               # 15c's mesh leg (4,000 before QUIC)
BOOT_HOST_MSGS = 8_000               # 15d's flood (16,000 before QUIC)
BOOT_TIMEOUT_S = 30.0
# the latency objective the override sets: at the 2 ms default every
# message of a flood beyond the node's rate breaches, and the governor
# (polled once start_timers runs) sheds QoS 0 and disconnects publishers
BOOT_SLO_MS = 5000
# phases 19 and 20: an objective their floods' tails keep (19a's p99
# reads over 5 s on the card): past it the governor sheds QoS 0 at
# critical, and a flood held to exactly-once must lose nothing
KNOWN_SLO_MS = 30_000


def boot_override(certs: dict) -> str:
    """The runtime-override file (``emqx_override.conf``, beside a copy
    of the shipped file in a temp dir) 15a boots with: the shipped
    listeners on
    127.0.0.1 port 0, the commented ``ssl_default`` listener with fresh
    certificates, the commented ``quic_default`` listener on the same
    certificates, the congestion alarm on with a short sustain, and an
    end-to-end objective a max-rate flood can keep (BOOT_SLO_MS)."""
    return (
        "listeners {\n"
        '  tcp_default { bind = "127.0.0.1", port = 0 }\n'
        '  ws_default { bind = "127.0.0.1", port = 0 }\n'
        '  ssl_default { type = ssl, bind = "127.0.0.1", port = 0\n'
        f'    ssl {{ certfile = "{certs["certfile"]}"\n'
        f'          keyfile = "{certs["keyfile"]}"\n'
        f'          cacertfile = "{certs["cacertfile"]}"\n'
        "          verify = verify_none } }\n"
        '  quic_default { type = quic, bind = "127.0.0.1", port = 0\n'
        f'    ssl {{ certfile = "{certs["certfile"]}"\n'
        f'          keyfile = "{certs["keyfile"]}" }} }}\n'
        "}\n"
        "conn_congestion { enable_alarm = true, "
        f"min_alarm_sustain_duration = {BOOT_SUSTAIN_S}s }}\n"
        f"broker.slo_route_p99_ms = {BOOT_SLO_MS}\n")


def _boot_ports(node) -> dict:
    """Transport -> port of a booted node's listeners."""
    out = {}
    for lst in node.listeners:
        kind = getattr(lst, "protocol", None) or lst.name.split(":")[0]
        out[{"mqtt:ws": "ws", "mqtt:wss": "wss",
             "mqtt:quic": "quic"}.get(kind, kind)] = lst.port
    return out


def _quic_listener(node):
    return next(x for x in node.listeners
                if getattr(x, "protocol", "") == "mqtt:quic")


def _quic_conn(port: int, certs: dict, **kw):
    """A QUIC client connection to the booted node's quic listener, its
    certificate chain and hostname verified against the run's CA."""
    from emqx_tpu_torch.quic import QuicClientConnection
    kw.setdefault("cafile", certs["cacertfile"])
    kw.setdefault("server_name", "localhost")
    return QuicClientConnection(port=port, **kw)


async def _quic_dial(qc) -> None:
    """Handshake under a deadline; then the client's socket asks for
    EXT_RCVBUF, as phase 20's UDP clients do (the listener keeps the
    reference's socket)."""
    import asyncio
    import socket
    await asyncio.wait_for(qc.connect(), BOOT_TIMEOUT_S)
    qc.transport.get_extra_info("socket").setsockopt(
        socket.SOL_SOCKET, socket.SO_RCVBUF, EXT_RCVBUF)


class _Udp:
    """A QUIC connection's socket as its connection sees it: every
    datagram handed to it counted, every `drop_every`-th dropped (none
    at 0), the rest sent."""

    def __init__(self, inner, drop_every: int = 0):
        self.inner = inner
        self.drop_every = drop_every
        self.sent = self.dropped = 0

    def sendto(self, data, addr=None):
        self.sent += 1
        if self.drop_every and self.sent % self.drop_every == 0:
            self.dropped += 1
            return
        self.inner.sendto(data, addr)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _udp_drops(port: int):
    """The kernel's receive drops on the UDP socket bound to local port
    `port` (/proc/net/udp's last column; None where it is not listed)."""
    try:
        with open("/proc/net/udp") as fh:
            rows = fh.read().splitlines()[1:]
    except OSError:
        return None
    for row in rows:
        f = row.split()
        if int(f[1].split(":")[1], 16) == port:
            return int(f[-1])
    return None


class _QuicTally:
    """One QUIC connection's counts (either side), taken around the
    instance's own methods and its socket: NewReno halvings (each starts
    a recovery window), retransmitted packets, datagrams sent and
    received; ``read`` adds cwnd, ssthresh, the bytes still blocked
    behind cwnd or flow control, and the kernel's drops on the local
    socket (`port`; the listener's socket is every server connection's)."""

    def __init__(self, conn, port: int, drop_every: int = 0):
        self.conn, self.port = conn, port
        self.halvings = self.retransmits = self.received = 0
        congestion, retransmit, received = (
            conn._congestion_event, conn._retransmit, conn.datagram_received)

        def congestion_event(sent_ts):
            was = conn._recovery_until
            congestion(sent_ts)
            self.halvings += conn._recovery_until != was

        def retransmitted(*a):
            self.retransmits += 1
            retransmit(*a)

        def datagram_received(*a):
            self.received += 1
            received(*a)
        conn._congestion_event = congestion_event
        conn._retransmit = retransmitted
        conn.datagram_received = datagram_received
        self.udp = conn.transport = _Udp(conn.transport, drop_every)

    def read(self) -> dict:
        q = quic_state(self.conn)
        return {"cwnd": q["cwnd"], "ssthresh": q["ssthresh"],
                "halvings": self.halvings, "retransmits": self.retransmits,
                "sent": self.udp.sent, "received": self.received,
                "dropped": self.udp.dropped,
                "socket_drops": _udp_drops(self.port),
                "blocked_bytes": q["blocked_bytes"]}


def quic_state(conn) -> dict:
    """What a QUIC connection (either side) holds: closed or not and why,
    cwnd, ssthresh, bytes in flight, unacked packets by level, bytes
    blocked, stream bytes sent against the peer's MAX_DATA, seconds since
    it last heard from its peer, and its 1-RTT packet numbers."""
    app = conn.spaces[2]
    return {"closed": conn.closed, "reason": conn.close_reason,
            "cwnd": conn.cwnd,
            "ssthresh": None if conn.ssthresh == float("inf")
            else conn.ssthresh,
            "in_flight": conn.bytes_in_flight,
            "unacked": [len(conn.spaces[lvl].unacked) for lvl in (0, 1, 2)],
            "blocked_bytes": sum(len(d) for d, _fin
                                 in conn._blocked_tx.values()),
            "tx_total": conn._tx_total, "peer_max_data": conn.peer_max_data,
            "quiet_s": round(time.monotonic() - conn.last_rx, 3),
            "app": {"next_pn": app.next_pn, "largest_rx": app.largest_rx,
                    "rx_floor": app.rx_floor, "rx_above": len(app.rx_pns),
                    "unacked_pns": [min(app.unacked, default=None),
                                    max(app.unacked, default=None)]}}


def _quic_report(where: str, tallies: dict) -> None:
    """Log every tallied QUIC connection's state and counts (a failed
    flood's last lines)."""
    log(f"phase {where}: the flood failed; QUIC connections (client / "
        f"listener side) " + json.dumps({
            cid: {side: dict(quic_state(t.conn), **t.read())
                  for side, t in sides.items()}
            for cid, sides in tallies.items()}))


def _server_conn(lst, qc):
    """The listener's connection for client connection `qc` (by the
    client socket's port)."""
    port = qc.transport.get_extra_info("sockname")[1]
    return next(c for c in set(lst._conns.values()) if c.addr[1] == port)


def _quic_tallies(lst, conns: dict, drop_every: int = 0) -> dict:
    """{name: {"client": tally, "server": tally}} for each client QUIC
    connection of `conns` ({name: connection}) and its listener side."""
    out = {}
    for name, qc in conns.items():
        out[name] = {
            "client": _QuicTally(qc, qc.transport.get_extra_info(
                "sockname")[1], drop_every),
            "server": _QuicTally(_server_conn(lst, qc), lst.port,
                                 drop_every)}
    return out


def _tally_delta(tallies: dict, before: dict) -> dict:
    """Each connection's counts since `before` (a ``read`` of each), its
    cwnd, ssthresh and blocked bytes as they stand."""
    out = {}
    for cid, sides in tallies.items():
        out[cid] = {}
        for side, t in sides.items():
            now, b = t.read(), before[cid][side]
            for k in ("halvings", "retransmits", "sent", "received",
                      "dropped"):
                now[k] -= b[k]
            if now["socket_drops"] is not None \
                    and b["socket_drops"] is not None:
                now["socket_drops"] -= b["socket_drops"]
            out[cid][side] = now
    return out


def _boot_client(ports: dict, transport: str, certs: dict, **kw):
    """A port Client over one of the booted node's transports; a QUIC
    one dials on its first CONNECT (one stream on its own connection,
    ``cl.quic``)."""
    from emqx_tpu_torch.broker.ws import open_ws_connection
    from emqx_tpu_torch.client import Client
    if transport == "quic":
        qc = _quic_conn(ports["quic"], certs)

        async def stream():
            if not qc.handshake_done.done():
                await _quic_dial(qc)
            return qc.open_stream()
        cl = Client(conn_factory=stream, **kw)
        cl.quic = qc
        return cl
    if transport == "ws":
        port = ports["ws"]
        return Client(conn_factory=lambda: open_ws_connection(
            "127.0.0.1", port), **kw)
    if transport == "ssl":
        kw["ssl"] = {"cacertfile": certs["cacertfile"]}
    return Client(port=ports[transport], **kw)


async def _boot_pubs(ports: dict, certs: dict, tag: str) -> tuple:
    """BOOT_PUBS' publishers, connected; (clients, {transport: indices})."""
    import asyncio
    pubs, groups = [], {}
    for tr, n in BOOT_PUBS:
        for _ in range(n):
            groups.setdefault(tr, []).append(len(pubs))
            cl = _boot_client(ports, tr, certs,
                              clientid=f"{tag}pub{len(pubs)}")
            await asyncio.wait_for(cl.connect(), BOOT_TIMEOUT_S)
            pubs.append(cl)
    return pubs, groups


def _plain_sets(f: dict, nums: int) -> list:
    """Per subscriber connection: the sorted (publisher, seq) pairs it got
    for plain (non-shared) filters."""
    return [sorted((p, s) for p, s, i, n, _q in rows
                   if not e2e_shared(i, n, nums)) for rows in f["got"]]


READBACK = ("pipeline.readback.bytes.dense", "pipeline.readback.bytes.compact",
            "pipeline.readback.windows.dense",
            "pipeline.readback.windows.compact",
            "routing.device.cold_compact_class",
            "routing.device.compact_overflow")


def hist_window(h, counts0: list) -> dict:
    """A telemetry histogram's observations since `counts0` (a copy of
    its counts): the count and the p50 / p99 upper bucket bounds in us
    (one quarter-octave over at most, ``Histogram.percentile``)."""
    d = [c - c0 for c, c0 in zip(h.counts, counts0)]
    n = sum(d)

    def pct(p):
        acc = 0
        for b, c in zip(h.bounds + [2 * h.bounds[-1]], d):
            acc += c
            if n and acc >= p * n:
                return round(b * 1e6, 1)
        return 0.0
    return {"count": n, "p50_us": pct(0.5), "p99_us": pct(0.99)}


async def _boot_flood(node, subs, pubs, ids, nums, total, seed, groups=None,
                      min_share=E2E_MIN_DEVICE_SHARE, where="",
                      device=True, retain_every: int = 0,
                      forbidden: int = 0) -> dict:
    """One flood through a booted node (``_flood``) with the readback
    counters, kernel 2's launches by shape and the batch_form stage (the
    message.publish hook fold) read around it; on a device node it
    checks the kernels and, with `min_share`, the device share."""
    from emqx_tpu_torch import device as D
    m = node.metrics
    r0 = {k: m.val(k) for k in READBACK}
    bf = node.pipeline_telemetry._stage_hist("batch_form")
    bf0 = list(bf.counts)
    f = await _flood(node, subs, pubs, ids, nums, total, seed,
                     groups=groups, retain_every=retain_every,
                     forbidden=forbidden)
    f["batch_form"] = hist_window(bf, bf0)
    f["readback"] = {k: m.val(k) - v for k, v in r0.items()}
    f["scan_shapes"] = dict(D.LAUNCH_SHAPES["prefix_sum"])
    f["fold_shapes"] = dict(D.LAUNCH_SHAPES["shape_match"])
    f["device_share"] = f["device_routed"] / f["sent"]
    f["readback_bytes_per_msg"] = (
        f["readback"]["pipeline.readback.bytes.dense"]
        + f["readback"]["pipeline.readback.bytes.compact"]) / f["sent"]
    if not device:
        return f
    if f["batches"] <= 0 or f["device_share"] < min_share:
        raise AssertionError(f"{where}: {f['device_share']:.3f} of the "
                             f"flood routed by the device engine")
    cuda = node.device.type == "cuda"
    if cuda and (f["launches"]["shape_match"] == 0
                 or f["launches"]["prefix_sum"] == 0):
        raise AssertionError(f"{where}: a kernel was not launched: "
                             f"{f['launches']}")
    if cuda and node.device_engine._built.backend == "shapes" \
            and f["launches"]["shape_match"] != f["windows"]:
        raise AssertionError(f"{where}: {f['launches']['shape_match']} "
                             f"shape_match launches for {f['windows']} "
                             f"windows")
    return f


async def _boot_conn(node, certs, ports, tr, clientid, **kw):
    """CONNECT (v5 unless `kw` says otherwise) over transport `tr`; the
    CONNACK reason code. A QUIC client's connection closes after it."""
    import asyncio

    from emqx_tpu_torch.client import MqttError
    from emqx_tpu_torch.mqtt import constants as C
    kw.setdefault("proto_ver", C.MQTT_V5)
    cl = _boot_client(ports, tr, certs, clientid=clientid, **kw)
    try:
        await asyncio.wait_for(cl.connect(), BOOT_TIMEOUT_S)
    except MqttError:
        pass
    rc = cl.connack.reason_code if cl.connack is not None else None
    await asyncio.wait_for(cl.disconnect(), BOOT_TIMEOUT_S)
    if getattr(cl, "quic", None) is not None:
        cl.quic.close(0, "", app=True)
    return rc


async def _boot_layers(node, certs, ports, pub) -> dict:
    """15b: the banned table, the OS monitor and the congestion alarm on
    the booted node."""
    import asyncio

    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.mqtt import constants as C
    out = {}
    # the flood before may leave the governor pausing CONNECTs (0x97):
    # the ban's codes are read below its overload grade
    out["governor_wait_s"] = await _below_overload(node)
    # a banned clientid is refused (0x8A) over every transport, and
    # admitted once its ban expired and sweep ran
    t_ban = time.time()
    node.banned.create("clientid", "boot-banned", reason="phase 15b",
                       duration=BOOT_BAN_S)
    refused = {tr: await _boot_conn(node, certs, ports, tr, "boot-banned")
               for tr in ports}
    await asyncio.sleep(max(0.0, t_ban + BOOT_BAN_S + 0.05 - time.time()))
    node.sweep()
    left = len(node.banned.all())
    admitted = {tr: await _boot_conn(node, certs, ports, tr, "boot-banned")
                for tr in ports}
    out["banned"] = {"refused": refused, "left_after_sweep": left,
                     "admitted": admitted}
    if set(refused.values()) != {C.RC_BANNED} or left \
            or set(admitted.values()) != {0}:
        raise AssertionError(f"phase 15b: banned {out['banned']}")
    # the OS monitor's readings and the alarms it raised (the reference's
    # behaviour: printed, not failed on)
    node.os_mon.tick()
    out["os_mon"] = {"info": node.os_mon.info(),
                     "watermarks": [node.os_mon.sysmem_high,
                                    node.os_mon.procmem_high],
                     "alarms": [
                         {"name": a["name"], "details": a.get("details")}
                         for a in node.alarms.get_alarms("activated")
                         if a["name"].startswith("high_")]}
    # a subscriber that stops reading during a QoS 0 burst: its
    # connection's send buffer fills, the timer tick raises the alarm;
    # once it reads again and the buffer stays empty for the sustain,
    # the alarm clears
    m = node.metrics
    name = "conn_congestion/boot-slow/unknown_user"
    slow = Client(port=ports["tcp"], clientid="boot-slow")
    await slow.connect()
    await slow.subscribe("boot/slow/#", qos=0)
    cong0 = m.val("connection.congested")
    shed0 = m.val("pipeline.overload.qos0_shed")
    slow._writer.transport.pause_reading()
    payload = b"s" * BOOT_SLOW_PAYLOAD
    t0 = time.perf_counter()
    for k in range(BOOT_SLOW_MSGS):
        pub.publish_start("boot/slow/t", payload, qos=0)
        if pub.needs_drain:
            await pub.drain()
    await pub.drain()
    raised = None
    for _ in range(int(BOOT_TIMEOUT_S / 0.05)):
        if node.alarms.is_active(name):
            raised = time.perf_counter() - t0
            break
        await asyncio.sleep(0.05)
    t1 = time.perf_counter()
    slow._writer.transport.resume_reading()
    got = 0
    cleared = None
    for _ in range(int(BOOT_TIMEOUT_S / 0.05)):
        while not slow.messages.empty():
            slow.messages.get_nowait()
            got += 1
        if got and not node.alarms.is_active(name):
            cleared = time.perf_counter() - t1
            break
        await asyncio.sleep(0.05)
    # the rest of the burst (up to ~40 MB queued for the socket) drains
    # after the alarm clears: read until every message is accounted for
    # or the client stays idle for a second
    idle_since = time.perf_counter()
    while time.perf_counter() - t1 < BOOT_TIMEOUT_S \
            and time.perf_counter() - idle_since < 1.0 \
            and got + m.val("pipeline.overload.qos0_shed") - shed0 \
            < BOOT_SLOW_MSGS:
        while not slow.messages.empty():
            slow.messages.get_nowait()
            got += 1
            idle_since = time.perf_counter()
        await asyncio.sleep(0.05)
    shed = m.val("pipeline.overload.qos0_shed") - shed0
    out["congestion"] = {
        "sent": BOOT_SLOW_MSGS, "payload": BOOT_SLOW_PAYLOAD,
        "received": got, "qos0_shed": shed,
        "raised_after_s": raised, "cleared_after_s": cleared,
        "congested": m.val("connection.congested") - cong0,
        "sustain_s": BOOT_SUSTAIN_S}
    await slow.disconnect()
    if raised is None or cleared is None \
            or out["congestion"]["congested"] < 1:
        raise AssertionError(f"phase 15b: congestion {out['congestion']}")
    if got + shed != BOOT_SLOW_MSGS:
        raise AssertionError(f"phase 15b: {got} received and {shed} shed "
                             f"of {BOOT_SLOW_MSGS}")
    return out


# 15e: each refused handshake and what its error must say
BOOT_REFUSALS = {"untrusted_ca": "not issued by trusted CA",
                 "hostname_mismatch": "hostname",
                 "no_common_alpn": "no common ALPN protocol"}


async def _quic_client(ports, certs, clientid: str, qc=None, **kw):
    """A port Client on one stream of QUIC connection `qc` (dialled here
    when None), connected (v5) under a deadline; (client, qc)."""
    import asyncio

    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.mqtt import constants as C
    if qc is None:
        qc = _quic_conn(ports["quic"], certs)
        await _quic_dial(qc)

    async def stream():
        return qc.open_stream()
    cl = Client(clientid=clientid, proto_ver=C.MQTT_V5, conn_factory=stream,
                **kw)
    ack = await asyncio.wait_for(cl.connect(), BOOT_TIMEOUT_S)
    if ack.reason_code != 0:
        raise AssertionError(f"phase 15e: {clientid} CONNACK "
                             f"{ack.reason_code:#x}")
    return cl, qc


async def _boot_quic(node, certs, ports, tmp: str,
                     lossy_msgs: int = BOOT_LOSSY_MSGS) -> dict:
    """15e on the booted node's quic listener: the TLS engine's three
    refusals (an untrusted CA, a hostname mismatch, no common ALPN), each
    leaving no connection behind; a Retry round trip (the listener's
    address validation turned on for it); `lossy_msgs` QoS 1 messages
    through a connection that drops every BOOT_LOSSY_EVERY-th datagram
    both ways, delivered once and in order; and idle reaping of a client
    gone silent (its last receive dated back past IDLE_TIMEOUT_S)."""
    import asyncio

    from emqx_tpu_torch.quic import connection as QC
    from emqx_tpu_torch.utils.tls import generate_self_signed
    lst = _quic_listener(node)
    out = {"governor_wait_s": await _below_overload(node)}
    base = lst.current_conns
    other = generate_self_signed(os.path.join(tmp, "evil"), ca_cn="evil-ca")
    refused = {}
    for case, kw in (("untrusted_ca", {"cafile": other["cacertfile"]}),
                     ("hostname_mismatch",
                      {"server_name": "evil.example.com"}),
                     ("no_common_alpn", {})):
        qc = _quic_conn(ports["quic"], certs, **kw)
        if case == "no_common_alpn":
            qc.tls._alpn = ["h3"]
        try:
            await _quic_dial(qc)
            refused[case] = None
        except (ConnectionError, asyncio.TimeoutError) as e:
            refused[case] = f"{type(e).__name__}: {e}"
        finally:
            qc.close(0, "", app=True)
    out["refused"] = refused
    out["refused_left_s"] = await _until(
        lambda: lst.current_conns == base, BOOT_TIMEOUT_S)
    if any(r is None or BOOT_REFUSALS[c] not in r
           for c, r in refused.items()):
        raise AssertionError(f"phase 15e: refusals {refused}")
    # a Retry round trip: the client follows the Retry (a new CID and a
    # token) and serves MQTT on the connection it validated
    lst.retry = True
    try:
        cl, qc = await _quic_client(ports, certs, "boot-retry")
    finally:
        lst.retry = False
    out["retry"] = {"saw_retry": qc._saw_retry,
                    "token_bytes": len(qc.initial_token)}
    await asyncio.wait_for(cl.disconnect(), BOOT_TIMEOUT_S)
    qc.close(0, "", app=True)
    if not qc._saw_retry or not qc.initial_token:
        raise AssertionError(f"phase 15e: retry {out['retry']}")
    # QoS 1 through a dropper: every BOOT_LOSSY_EVERY-th datagram lost in
    # each direction, recovered by the packet threshold and the PTO
    qc = _quic_conn(ports["quic"], certs)
    await _quic_dial(qc)
    tallies = _quic_tallies(lst, {"boot-lossy": qc}, BOOT_LOSSY_EVERY)
    t0 = time.perf_counter()
    cl, _qc = await _quic_client(ports, certs, "boot-lossy", qc)
    await cl.subscribe("boot/lossy/t", qos=1, timeout=BOOT_TIMEOUT_S)
    acks = [cl.publish_start("boot/lossy/t", b"m%d" % i, qos=1)
            for i in range(lossy_msgs)]
    done, owed = await asyncio.wait(acks, timeout=BOOT_TIMEOUT_S)
    if owed:
        raise AssertionError(f"phase 15e: {len(owed)} of {lossy_msgs} "
                             f"PUBACKs owed through the dropper; QUIC "
                             f"{json.dumps(quic_state(qc))}")
    for a in done:
        a.result()
    got = [(await asyncio.wait_for(cl.messages.get(),
                                   BOOT_TIMEOUT_S)).payload
           for _ in range(lossy_msgs)]
    await asyncio.sleep(0.2)             # a duplicate would land by now
    dup = cl.messages.qsize()
    lossy_s = time.perf_counter() - t0
    conns = {side: t.read() for side, t in tallies["boot-lossy"].items()}
    await asyncio.wait_for(cl.disconnect(), BOOT_TIMEOUT_S)
    qc.close(0, "", app=True)
    out["lossy"] = {"msgs": lossy_msgs, "every": BOOT_LOSSY_EVERY,
                    "s": lossy_s, "duplicates": dup, "connections": conns}
    if got != [b"m%d" % i for i in range(lossy_msgs)] or dup \
            or not all(c["dropped"] for c in conns.values()):
        raise AssertionError(f"phase 15e: lossy {got} {out['lossy']}")
    # idle reaping: the client goes silent; its server connection, last
    # heard from longer ago than IDLE_TIMEOUT_S, is closed on the next
    # PTO tick and forgotten (the lossy connection's close may have been
    # dropped: it stays until the listener stops)
    qc = _quic_conn(ports["quic"], certs)
    await _quic_dial(qc)
    conn = _server_conn(lst, qc)
    await _until(lambda: conn.handshake_done.done(), BOOT_TIMEOUT_S)
    qc.transport.close()
    qc.transport = None
    await asyncio.sleep(0.1)       # what the client sent before has landed
    conn.last_rx -= QC.IDLE_TIMEOUT_S
    out["idle_reaped_s"] = await _until(
        lambda: conn.closed and conn not in lst._conns.values(),
        BOOT_TIMEOUT_S)
    out["idle_reason"] = conn.close_reason
    qc.close(0, "", app=True)
    return out


def _quic_stopped(lst, conns: list, tasks: list) -> dict:
    """What ``stop_listeners`` left of the quic listener: its UDP socket,
    the connections and MQTT tasks it had before the stop."""
    out = {"socket_closed": lst._transport.is_closing(),
           "connections": len(conns),
           "open": sum(not c.closed for c in conns),
           "listed": len(lst._conns), "current_conns": lst.current_conns,
           "mqtt_tasks": len(tasks),
           "tasks_running": sum(not t.done() for t in tasks)
           + len(lst._mqtt_tasks)}
    if not out["socket_closed"] or out["open"] or out["listed"] \
            or out["current_conns"] or out["tasks_running"]:
        raise AssertionError(f"phase 15e: stop_listeners left {out}")
    return out


def _burst_counter():
    """Count columnar-burst rows by the listener port they came in on
    (the channel's sockname): the burst share by transport."""
    from emqx_tpu_torch.broker.channel import Channel
    rows: dict = {}
    orig = Channel.handle_publish_burst

    async def counted(self, burst):
        port = (self.conninfo.get("sockname") or ("?", 0))[1]
        rows[port] = rows.get(port, 0) + len(burst.topics)
        return await orig(self, burst)
    return rows, orig, counted


async def _boot_node_drive(node, certs, n_filters, n_sub, pin_device, tag,
                           quic_subs: int = 0):
    """Start the node's listeners, connect BOOT_PUBS' publishers and
    subscribe phase 8's population over TCP, the first `quic_subs`
    subscriber connections over QUIC (every connection before the first
    SUBSCRIBE, see _subscribe_population); returns (ports, subs, pubs,
    groups, ids, nums, shared filters, subscriptions)."""
    import asyncio
    await asyncio.wait_for(node.start_listeners(), BOOT_TIMEOUT_S)
    ports = _boot_ports(node)
    pubs, groups = await _boot_pubs(ports, certs, tag)
    subs, ids, nums, n_shared, n_entries = \
        await _subscribe_population(
            ports["tcp"], n_filters, n_sub, make=lambda c, cid: _boot_client(
                ports, "quic", certs, clientid=cid) if c < quic_subs
            else None)
    if pin_device and node.publish_batcher is not None:
        node.publish_batcher._device_worth_it = lambda: True
    return ports, subs, pubs, groups, ids, nums, n_shared, n_entries


async def _boot_stop(node, clients) -> None:
    """Disconnect the clients, stop the timers and the listeners (each
    under a deadline), close the clients' QUIC connections and the
    batcher."""
    import asyncio
    for cl in clients:
        await asyncio.wait_for(cl.disconnect(), BOOT_TIMEOUT_S)
    node.stop_timers()
    await asyncio.wait_for(node.stop_listeners(), BOOT_TIMEOUT_S)
    for cl in clients:
        if getattr(cl, "quic", None) is not None:
            cl.quic.close(0, "", app=True)
    if node.publish_batcher is not None:
        await node.publish_batcher.stop()
        node.publish_batcher.close()


def _mesh_leg(dev, conf_fn, n_filters, n_sub, total, seed) -> dict:
    """15c's mesh leg: a multichip node with compact_readback false and
    its CSR twin, phase 8's population subscribed in-process, the same
    windows through both (route_batch of max_batch, classes warmed
    first): equal deliveries per session, dense readback only on the
    dense one, kernel launches read around each drive."""
    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    ids, nums = e2e_grid(n_filters)
    r = np.random.RandomState(seed)
    topics = [f"device/d{i}/x/n{k}/t" for i, k in zip(
        r.randint(0, ids, total), r.randint(0, nums, total))]
    out, sinks = {}, {}
    for mode, compact in (("dense", False), ("csr", True)):
        conf = conf_fn()
        conf.update(("broker", "compact_readback"), compact, persist=False)
        conf.update(("broker", "multichip"), {
            "enable": True, "devices": MN_DEVICES, "dp": MN_DP},
            persist=False)
        node = Node(conf, device=dev)
        eng, m = node.device_engine, node.metrics
        try:
            sk = _populate(node, ids, nums, n_sub)
            t0 = time.time()
            eng.route_batch([make("w", 0, "warmup/none/t", b"")], wait=True)
            Bp = eng.n_dp
            while Bp <= eng.max_batch:
                eng._warm_one(Bp)
                Bp *= 2
            wr = np.random.RandomState(seed + 1)
            _warm_mesh_exchange(eng, make, lambda n: [
                f"device/d{i}/x/n{k}/t" for i, k in zip(
                    wr.randint(0, ids, n), wr.randint(0, nums, n))],
                eng.max_batch, m)
            warm_s = time.time() - t0
            _take(sk)
            r0 = {k: m.val(k) for k in READBACK}
            D.reset_launches()
            t0 = time.perf_counter()
            B = eng.max_batch
            counts = []
            for k in range(0, total, B):
                counts += eng.route_batch(
                    [make(f"p{k // B % 8}", 0, t, b"%d" % (k + j))
                     for j, t in enumerate(topics[k:k + B])], wait=True)
            dt = time.perf_counter() - t0
            launches = dict(D.LAUNCHES)
            out[mode] = {
                "msgs": total, "delivered": int(sum(counts)),
                "per_sec": int(round(total / dt)), "warm_s": warm_s,
                "windows": -(-total // B), "launches": launches,
                "scan_shapes": dict(D.LAUNCH_SHAPES["prefix_sum"]),
                "readback": {k: m.val(k) - v for k, v in r0.items()},
                "compact_readback": eng.stats()["compact_readback"]}
            sinks[mode] = _take(sk)
            if eng.failed is not None:
                raise AssertionError(f"phase 15c mesh {mode}: the server "
                                     f"failed: {eng.failed!r}")
        finally:
            node.publish_batcher.close()
            eng.close()
    d, c = out["dense"], out["csr"]
    if sinks["dense"] != sinks["csr"] or d["delivered"] != total:
        raise AssertionError(
            f"phase 15c mesh: dense and CSR deliveries differ "
            f"({d['delivered']} / {c['delivered']} of {total})")
    rb = d["readback"]
    if rb["pipeline.readback.windows.compact"] \
            or rb["routing.device.cold_compact_class"] \
            or not rb["pipeline.readback.windows.dense"]:
        raise AssertionError(f"phase 15c mesh: dense node read back {rb}")
    if dev.type == "cuda" and d["launches"]["prefix_sum"] == 0:
        raise AssertionError(f"phase 15c mesh: kernel 2 was not launched: "
                             f"{d['launches']}")
    return out


def boot_drive(dev, n_filters: int = E2E_FILTERS,
               n_sub: int = E2E_SUB_CONNS, total: int = BOOT_MSGS,
               dense_total: int = BOOT_DENSE_MSGS,
               mesh_total: int = BOOT_MESH_MSGS,
               host_total: int = BOOT_HOST_MSGS, seed: int = SEED,
               pin_device: bool = False, conf_path: str = BOOT_CONF,
               lossy_msgs: int = BOOT_LOSSY_MSGS) -> dict:
    """Phase 15: the default node booted from the repo's ``etc/emqx.conf``,
    copied unchanged to a temp dir with ``emqx_override.conf`` beside it
    (``Config.load_file``, then ``Node.from_config_file``,
    ``start_listeners`` and ``start_timers``):
    15a phase 8's population over TCP and QUIC and a flood from
    publishers over TCP, TLS, WebSocket and QUIC; 15b the banned table,
    the OS monitor and the congestion alarm on that node; 15c the dense
    readback against the CSR one (a flood on a ``compact_readback:
    false`` node against the booted one, then a mesh node and its CSR
    twin, at a quarter of the population); 15d the host-only node
    (``device_route: false``, a quarter of the population); 15e the
    booted node's quic listener (``_boot_quic``, then what
    ``stop_listeners`` leaves of it). ``pin_device`` pins the chooser (a
    CPU rehearsal only). Raises on any failed check."""
    import asyncio
    import shutil
    import tempfile

    import torch

    from emqx_tpu_torch.broker import channel as CH
    from emqx_tpu_torch.broker.config import Config
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.utils.tls import generate_self_signed
    tmp = tempfile.mkdtemp(prefix="emqx-boot-")
    cuda = dev.type == "cuda"

    async def run():
        out = {}
        t0 = time.time()
        certs = generate_self_signed(os.path.join(tmp, "certs"),
                                     cn="localhost")
        # the shipped file, unchanged, with the override beside it: the
        # reference's boot (emqx_override.conf next to emqx.conf)
        path = os.path.join(tmp, "emqx.conf")
        shutil.copy(conf_path, path)
        with open(os.path.join(tmp, "emqx_override.conf"), "w") as fh:
            fh.write(boot_override(certs))
        conf = Config.load_file(path)
        want = {"tcp_default", "ws_default", "ssl_default", "quic_default"}
        if set(conf.get("listeners")) != want:
            raise AssertionError(f"phase 15a: listeners "
                                 f"{sorted(conf.get('listeners'))}")
        out["certs_s"] = time.time() - t0
        alloc0 = torch.cuda.memory_allocated(dev) if cuda else None
        node = Node.from_config_file(path, device=dev)
        clients = []
        try:
            t0 = time.time()
            ports, subs, pubs, groups, ids, nums, n_shared, n_entries = \
                await _boot_node_drive(node, certs, n_filters, n_sub,
                                       pin_device, "a", BOOT_QUIC_SUBS)
            clients += subs + pubs
            lst_q = _quic_listener(node)
            tallies = _quic_tallies(lst_q, {
                cl.clientid: cl.quic for cl in subs + pubs
                if getattr(cl, "quic", None) is not None})
            node.start_timers()
            out["a"] = {"filters": ids * nums, "shared_filters": n_shared,
                        "connections": n_sub,
                        "quic_connections": min(BOOT_QUIC_SUBS, n_sub),
                        "subscriptions": n_entries,
                        "subscribe_s": time.time() - t0,
                        "listeners": sorted(
                            [getattr(x, "name", None) or x.protocol,
                             x.port > 0] for x in node.listeners),
                        "log_handlers": len(logging.getLogger(
                            "emqx_tpu_torch").handlers)}
            t0 = time.time()
            await _warm_up(node, pubs[0], subs, nums)
            out["a"]["warm_up_s"] = time.time() - t0
            gc.collect()
            gc.freeze()
            rows, orig, counted = _burst_counter()
            CH.Channel.handle_publish_burst = counted
            q0 = {cid: {side: t.read() for side, t in sides.items()}
                  for cid, sides in tallies.items()}
            try:
                f = await asyncio.wait_for(_boot_flood(
                    node, subs, pubs, ids, nums, total, seed, groups,
                    where="phase 15a"), BOOT_FLOOD_S)
            except (AssertionError, asyncio.TimeoutError):
                _quic_report("15a", tallies)
                raise
            finally:
                CH.Channel.handle_publish_burst = orig
            for tr, g in f["by_group"].items():
                g["burst_share"] = rows.get(ports[tr], 0) / g["sent"]
            f.pop("got")
            out["a"]["flood"] = f
            out["a"]["quic"] = _tally_delta(tallies, q0)
            out["a"]["supervise"] = check_supervised(node, "phase 15a")
            gov = node.overload_governor
            out["a"]["governor"] = {"grade": gov.state()["grade"],
                                    "grade_changes": gov.grade_changes}
            out["a"]["ledger"] = ledger_line(node, alloc0) \
                if node.hbm_ledger is not None else None
            # 15b on the same node
            out["b"] = await _boot_layers(node, certs, ports, pubs[0])
            out["b"]["governor"] = {"grade": gov.state()["grade"],
                                    "grade_changes": gov.grade_changes}
            # 15c, the CSR side: the booted (default) node's flood
            try:
                csr = await asyncio.wait_for(_boot_flood(
                    node, subs, pubs, ids, nums, dense_total, seed + 300,
                    min_share=0, where="phase 15c csr"), BOOT_FLOOD_S)
            except (AssertionError, asyncio.TimeoutError):
                _quic_report("15c csr", tallies)
                raise
            out["c"] = {"csr": csr}
            # 15e on the same node
            out["e"] = await _boot_quic(node, certs, ports, tmp, lossy_msgs)
            q_conns = list(set(lst_q._conns.values()))
            q_tasks = list(lst_q._mqtt_tasks)
        finally:
            gc.unfreeze()
            await _boot_stop(node, clients)
        out["e"]["stopped"] = _quic_stopped(lst_q, q_conns, q_tasks)
        # 15c: a compact_readback: false node, the same flood
        dconf = Config.load_file(path)
        dconf.update(("broker", "compact_readback"), False, persist=False)
        dense_node = Node(dconf, device=dev)
        clients = []
        try:
            ports, subs, pubs, groups, ids, nums, _s, _e = \
                await _boot_node_drive(dense_node, certs, n_filters, n_sub,
                                       pin_device, "c")
            clients += subs + pubs
            await _warm_up(dense_node, pubs[0], subs, nums)
            gc.collect()
            gc.freeze()
            dense = await _boot_flood(dense_node, subs, pubs, ids, nums,
                                      dense_total, seed + 300, min_share=0,
                                      where="phase 15c dense")
            out["c"]["dense"] = dense
            out["c"]["supervise"] = check_supervised(dense_node,
                                                     "phase 15c")
        finally:
            gc.unfreeze()
            await _boot_stop(dense_node, clients)
        rb = dense["readback"]
        if rb["pipeline.readback.windows.compact"] \
                or rb["routing.device.cold_compact_class"] \
                or not rb["pipeline.readback.windows.dense"]:
            raise AssertionError(f"phase 15c: the dense node read back {rb}")
        if _plain_sets(dense, nums) != _plain_sets(out["c"]["csr"], nums):
            raise AssertionError("phase 15c: dense and CSR plain deliveries "
                                 "differ per session")
        for f in (dense, out["c"]["csr"]):
            f.pop("got")
        # 15d: the host-only node
        if cuda:
            torch.cuda.synchronize(dev)
        alloc0 = torch.cuda.memory_allocated(dev) if cuda else None
        hconf = Config.load_file(path)
        hconf.update(("broker", "device_route"), False, persist=False)
        host_node = Node(hconf, device=dev)
        if host_node.device_engine is not None \
                or host_node.publish_batcher is not None:
            raise AssertionError("phase 15d: the host-only node built a "
                                 "device engine or a batcher")
        clients = []
        try:
            ports, subs, pubs, groups, ids, nums, _s, _e = \
                await _boot_node_drive(host_node, certs, n_filters // 4,
                                       n_sub, False, "d")
            clients += subs + pubs
            gc.collect()
            gc.freeze()
            host = await _boot_flood(host_node, subs, pubs, ids, nums,
                                     host_total, seed + 400, groups,
                                     where="phase 15d", device=False)
            host.pop("got")
        finally:
            gc.unfreeze()
            await _boot_stop(host_node, clients)
        if cuda:
            torch.cuda.synchronize(dev)
        host["memory_allocated_delta"] = \
            torch.cuda.memory_allocated(dev) - alloc0 if cuda else None
        if any(host["launches"].values()) or host["device_routed"] \
                or host["memory_allocated_delta"]:
            raise AssertionError(
                f"phase 15d: the host-only node used the card: launches "
                f"{host['launches']}, {host['device_routed']} routed, "
                f"{host['memory_allocated_delta']} bytes")
        out["d"] = host
        return out

    try:
        out = asyncio.run(run())
        out["c"]["mesh"] = _mesh_leg(
            dev, lambda: Config.load_file(os.path.join(tmp, "emqx.conf")),
            n_filters // 4, n_sub, mesh_total, seed + 500)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _shape_rates(shapes: dict, windows: int) -> list:
    """Kernel launches a window by shape, largest first."""
    return [[list(k), round(v / max(1, windows), 3)]
            for k, v in sorted(shapes.items(), key=lambda kv: -kv[1])]


def boot_phase(dev, card: str) -> dict:
    """Phase 15 on the card; prints its lines."""
    t0 = time.time()
    r = boot_drive(dev)
    a, b, c, d, e = r["a"], r["b"], r["c"], r["d"], r["e"]
    f = a["flood"]
    log(f"phase 15a: booted etc/emqx.conf with a runtime override "
        f"(certificates made by generate_self_signed in "
        f"{r['certs_s']:.2f} s); listeners {a['listeners']}; "
        f"{a['filters']} filters ({a['shared_filters']} shared) subscribed "
        f"over TCP and QUIC ({a['quic_connections']} of "
        f"{a['connections']} connections) in {a['subscribe_s']:.1f} s, "
        f"warm-up {a['warm_up_s']:.1f} s; logger handlers {a['log_handlers']}")
    log(f"phase 15a: {f['sent']} PUBLISHes from "
        f"{', '.join(f'{n} {tr}' for tr, n in BOOT_PUBS)}: {f['per_sec']} "
        f"msgs/s, every message once and in order; client p50 "
        f"{f['lat_p50_ms']:.1f} / p99 {f['lat_p99_ms']:.1f} ms; device "
        f"share {f['device_share']:.4f} over {f['windows']} windows "
        f"({f['batches']} batches); {card}")
    for tr, g in f["by_group"].items():
        conns = "" if tr != "quic" else (
            f"; per connection over the flood (client / listener side: "
            f"cwnd, ssthresh, halvings, retransmits, datagrams sent, "
            f"received, dropped by the socket, bytes blocked) "
            + "; ".join(f"{cid} " + " / ".join(
                f"{q['cwnd']}, {q['ssthresh']}, {q['halvings']}, "
                f"{q['retransmits']}, {q['sent']}, {q['received']}, "
                f"{q['socket_drops']}, {q['blocked_bytes']}"
                for q in (sides["client"], sides["server"]))
                for cid, sides in a["quic"].items()))
        log(f"phase 15a {tr}: {g['sent']} msgs from {g['publishers']} "
            f"publishers, {g['per_sec']} msgs/s delivered, p50 "
            f"{g['lat_p50_ms']:.1f} / p99 {g['lat_p99_ms']:.1f} ms, burst "
            f"share {g['burst_share']:.3f}{conns}")
    log(f"phase 15a: launches {f['launches']}; a window: shape_match "
        f"{_shape_rates(f['fold_shapes'], f['windows'])}, prefix_sum "
        f"{_shape_rates(f['scan_shapes'], f['windows'])}")
    log(f"phase 15a: the governor (polled every 1 s, objective "
        f"{BOOT_SLO_MS} ms) after the flood {a['governor']}, after 15b "
        f"{b['governor']}")
    log(f"phase 15b: banned {b['banned']}")
    log(f"phase 15b: OsMon {b['os_mon']}")
    log(f"phase 15b: congestion {b['congestion']}")
    for mode in ("csr", "dense"):
        x = c[mode]
        log(f"phase 15c {mode}: {x['sent']} msgs {x['per_sec']} msgs/s, "
            f"share {x['device_share']:.4f}, readback "
            f"{x['readback_bytes_per_msg']:.1f} B/msg, windows dense "
            f"{x['readback']['pipeline.readback.windows.dense']} / compact "
            f"{x['readback']['pipeline.readback.windows.compact']} of "
            f"{x['windows']}; prefix_sum a window "
            f"{_shape_rates(x['scan_shapes'], x['windows'])}")
    for mode in ("dense", "csr"):
        x = c["mesh"][mode]
        log(f"phase 15c mesh {mode}: {x['msgs']} msgs in {x['windows']} "
            f"windows, {x['per_sec']} msgs/s, launches {x['launches']}, "
            f"readback {x['readback']}; deliveries equal per session")
    log(f"phase 15d host-only: {d['sent']} msgs {d['per_sec']} msgs/s, "
        f"every message once and in order; launches {d['launches']}; "
        f"memory_allocated delta {d['memory_allocated_delta']} B; client "
        f"p50 {d['lat_p50_ms']:.1f} / p99 {d['lat_p99_ms']:.1f} ms")
    lo = e["lossy"]
    log(f"phase 15e: refused {json.dumps(e['refused'])}, no connection left "
        f"after {e['refused_left_s']:.2f} s; retry {json.dumps(e['retry'])}"
        f"; {lo['msgs']} QoS 1 with every {lo['every']}rd datagram dropped "
        f"both ways, delivered once and in order in {lo['s']:.2f} s "
        f"(client / listener side {json.dumps(lo['connections'])}); a "
        f"silent client reaped in {e['idle_reaped_s']:.2f} s "
        f"({e['idle_reason']}); stop_listeners {json.dumps(e['stopped'])}")
    r["seconds"] = time.time() - t0
    log(f"phase 15: {r['seconds']:.1f} s; {card}")
    return r


# ---- phase 16: the feature apps and the management API ------------------

APPS_RETAIN_EVERY = 8                # 16a: every 8th PUBLISH retained
APPS_MSGS = 8_000                    # 16a's flood (16,000 before QUIC)
APPS_RETAINED = 50_000               # 16b: half CONFIG5_10M.json's retained
                                     # (all 100,000 before QUIC)
APPS_RETAINED_GROUPS = 64            # 16b: c5r/{i % 64}/k{i}
# 16a's topic metrics: two filters of the flood's shape (its topics are
# device/d{i}/x/n{n}/t), over 1/ids and 1/nums of it (~50 of 16,000)
APPS_TM_FILTERS = ("device/d0/+/+/#", "device/+/x/n0/#")
APPS_DELAY_S = 2                     # 16d's $delayed/2/...
APPS_FLAP_MAX = 5                    # 16d: flapping_detect max_count
APPS_BAN_S = 2                       # 16d: flapping_detect ban_time
APPS_TIMEOUT_S = 60.0
APPS_PACE = 4096                     # 16b: a QoS 1 PUBLISH acked every
                                     # this many retained ones
APPS_GOVERNOR_S = 180.0              # the longest wait for the governor
APPS_HOLD_S = 6.0                    # 16b: the 1 s sweeps read with the
                                     # 100,000 retained stored
# the later legs' clients (16b's publisher and subscribers, 16c's, 16d's)
APPS_LATE_CLIENTS = ("c5-pub", "c5-sub", "c5-one", "c5-rh2", "c5-defer",
                     "op-sub", "op-pub", "op-sys")


def apps_override(certs: dict) -> str:
    """Phase 15's override plus the dashboard on 127.0.0.1 port 0, one
    rewrite rule no flood topic matches, topic metrics on
    APPS_TM_FILTERS and flapping detection (the shipped file's retainer
    and delayed publish stay on)."""
    return boot_override(certs) + (
        'dashboard { listeners { http { bind = "127.0.0.1", port = 0 } } }\n'
        'rewrite = [ { action = publish, source = "rw/src/#",\n'
        '              re = "^rw/src/(.+)$", dest = "rw/dst/$1" } ]\n'
        f'topic_metrics = {json.dumps(list(APPS_TM_FILTERS))}\n'
        f"flapping_detect {{ enable = true, max_count = {APPS_FLAP_MAX}, "
        f"window_time = 10, ban_time = {APPS_BAN_S} }}\n")


async def _http(port: int, method: str, path: str, body=None,
                bearer=None) -> tuple:
    """One HTTP/1.1 request to the dashboard server: (status, JSON body
    or raw bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    hdrs = [f"{method} {path} HTTP/1.1", "host: x",
            f"content-length: {len(data)}", "connection: close"]
    if bearer:
        hdrs.append(f"authorization: Bearer {bearer}")
    writer.write(("\r\n".join(hdrs) + "\r\n\r\n").encode() + data)
    await writer.drain()
    raw = await reader.read(-1)
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    if b"application/json" in head:
        payload = json.loads(payload) if payload else None
    return int(head.split()[1]), payload


async def _recv_all(cl, idle_s: float = 0.5, limit: float = APPS_TIMEOUT_S):
    """Every message a client receives until it is idle for `idle_s`."""
    import asyncio
    got, t_end = [], time.perf_counter() + limit
    while time.perf_counter() < t_end:
        try:
            got.append(await cl.recv(timeout=idle_s))
        except asyncio.TimeoutError:
            break
    return got


async def _below_overload(node, limit: float = APPS_GOVERNOR_S) -> float:
    """Wait until the governor (polled by the node's 1 s timers) is below
    its overload grade, where defer_retained parks replays and
    pause_connects refuses CONNECTs; the seconds waited."""
    import asyncio
    gov, t0 = node.overload_governor, time.perf_counter()
    while gov.retained_deferred or gov.connects_paused:
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"the governor stayed at "
                                 f"{gov.state()['grade']} for {limit} s")
        await asyncio.sleep(0.1)
    return time.perf_counter() - t0


async def _apps_retained_stream(node, late: dict, retained: int) -> dict:
    """16b's stream: the c5-pub client sends `retained` retained QoS 0
    PUBLISHes c5r/{i % 64}/k{i} through the node's device path, paced by
    a QoS 1 PUBLISH acked every APPS_PACE (the stream keeps the node's
    queue short: a flood past its rate is phase 12's)."""
    import asyncio

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.apps.retainer import Retainer
    m = node.metrics
    ret = node.get_app(Retainer)
    base = ret.retained_count()
    pub = late["c5-pub"]
    w0 = m.val("routing.device.windows")
    dev0 = m.val("routing.device.messages")
    D.reset_launches()
    t0 = time.perf_counter()
    for i in range(retained):
        pub.publish_start(f"c5r/{i % APPS_RETAINED_GROUPS}/k{i}",
                          b"retained-%d" % i, qos=0, retain=True)
        if pub.needs_drain:
            await pub.drain()
        if i % APPS_PACE == APPS_PACE - 1:
            await pub.publish("c5s/pace", b"", qos=1,
                              timeout=APPS_TIMEOUT_S)
        elif i % 512 == 511:
            await asyncio.sleep(0)
        if i % 20_000 == 19_999:
            log(f"phase 16b: {i + 1} sent in "
                f"{time.perf_counter() - t0:.1f} s, "
                f"{ret.retained_count() - base} retained, "
                f"{m.val('routing.device.windows') - w0} device windows")
    # the retainer stores a message in the fold, before its window
    # routes: a QoS 1 PUBLISH behind the stream is acked once the stream
    # has routed, so no late subscriber meets its tail as live traffic
    await pub.publish("c5s/end", b"", qos=1, timeout=APPS_TIMEOUT_S)
    pub_s = time.perf_counter() - t0
    out = {"retained": retained, "publish_s": pub_s,
           "publish_per_sec": int(round(retained / pub_s)),
           "windows": m.val("routing.device.windows") - w0,
           "device_messages": m.val("routing.device.messages") - dev0,
           "launches": dict(D.LAUNCHES),
           "scan_shapes": dict(D.LAUNCH_SHAPES["prefix_sum"]),
           "fold_shapes": dict(D.LAUNCH_SHAPES["shape_match"]),
           "retained_count": node.stats.sample()["retained.count"]}
    if ret.retained_count() != base + retained:
        raise AssertionError(f"phase 16b: {ret.retained_count() - base} of "
                             f"{retained} retained")
    return out


async def _apps_stored_reading(node, ports) -> dict:
    """16b's reading with the retained messages stored: each 1 s sweep's
    expiry scan (``Retainer.tick``) returns at once while no stored entry
    carries an expiry, where the reference's scan built a list of every
    entry and its full collections, read by the governor's loop-lag
    probe, took the booted node to overload (ROADMAP Queue C). APPS_HOLD_S of the
    node's own sweeps, then one CONNECT: each sweep's seconds and each
    full collection's, the highest grade seen, the grade and loop lag
    after, the CONNACK (None: the acceptor lane closed the socket) and
    the governor's refusal counters so far."""
    import asyncio

    from emqx_tpu_torch.broker.overload import GRADES
    gov, m = node.overload_governor, node.metrics
    sweeps, full, t_gc = [], [], [0.0]

    def timed(sweep=node.sweep):
        t = time.perf_counter()
        sweep()
        sweeps.append(round(time.perf_counter() - t, 4))

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                t_gc[0] = time.perf_counter()
            else:
                full.append(round(time.perf_counter() - t_gc[0], 4))

    node.sweep = timed
    gc.callbacks.append(on_gc)
    try:
        top, t_end = gov.grade, time.perf_counter() + APPS_HOLD_S
        while time.perf_counter() < t_end:
            await asyncio.sleep(0.1)
            top = max(top, gov.grade)
    finally:
        del node.sweep
        gc.callbacks.remove(on_gc)
    st = gov.state()
    return {"sweeps_s": sweeps, "full_collections_s": full,
            "grade_max": GRADES[top], "grade": st["grade"],
            "loop_lag_ms": st["loop_lag_ms"],
            "connects_paused": gov.connects_paused,
            "connack": await _boot_conn(node, {}, ports, "tcp", "c5-probe"),
            "connects_rejected": m.val("pipeline.overload.connects_rejected"),
            "accepts_paused": m.val("pipeline.overload.accepts_paused")}


async def _apps_replay(node, ports, subs: dict, retained: int,
                       out: dict) -> dict:
    """16b's replays, with the governor below overload (a parked replay
    is 16c's): c5r/0/+, c5r/# with retain handling 2, then the whole
    c5r/# (one synchronous hook call: its stall may arm the governor, so
    it goes last)."""
    import asyncio

    from emqx_tpu_torch.apps.retainer import Retainer
    out["waited_s"] = await _below_overload(node)
    await subs["c5-one"].subscribe("c5r/0/+", qos=0)
    await subs["c5-rh2"].subscribe("c5r/#", qos=0, opts={"rh": 2})
    one = await _recv_all(subs["c5-one"])
    rh2 = await _recv_all(subs["c5-rh2"])
    out["waited_s"] += await _below_overload(node)
    t0 = time.perf_counter()
    await subs["c5-sub"].subscribe("c5r/#", qos=0, timeout=60)
    n_all, flags = 0, True
    t_end = time.perf_counter() + APPS_TIMEOUT_S
    while n_all < retained and time.perf_counter() < t_end:
        try:
            msg = await subs["c5-sub"].recv(timeout=5)
        except asyncio.TimeoutError:
            break
        n_all += 1
        flags = flags and bool(msg.retain)
    replay_s = time.perf_counter() - t0
    out["stored"] = await _apps_stored_reading(node, ports)
    # the store back to 16a's size, so that the governor can leave
    # overload for 16d (see _apps_stored_reading)
    t1 = time.perf_counter()
    node.sweep()
    sweep_s = time.perf_counter() - t1
    ret = node.get_app(Retainer)
    cleaned = ret.clean("c5r/#")
    t1 = time.perf_counter()
    node.sweep()
    out.update({"sweep_s_full": sweep_s, "cleaned": cleaned,
                "sweep_s_after": time.perf_counter() - t1})
    extra = await _recv_all(subs["c5-sub"], idle_s=0.2)
    want_one = len(range(0, retained, APPS_RETAINED_GROUPS))
    out.update({"replayed": n_all, "replay_s": replay_s,
                "replay_per_sec": int(round(n_all / replay_s)),
                "retain_flag": flags, "one_group": len(one),
                "one_group_want": want_one, "rh2": len(rh2),
                "duplicates": len(extra)})
    if n_all != retained or not flags or extra or cleaned != retained:
        raise AssertionError(f"phase 16b: c5r/# replayed {n_all} of "
                             f"{retained} (retain flag on all: {flags}, "
                             f"{len(extra)} more)")
    if len(one) != want_one or not all(x.retain for x in one) or rh2:
        raise AssertionError(f"phase 16b: c5r/0/+ got {len(one)} of "
                             f"{want_one}, rh 2 got {len(rh2)}")
    return out


async def _apps_warm_stress(node, late: dict, retained: int) -> dict:
    """``--warm-stress``, the reproducer of a fault (ROADMAP Queue C,
    fixed): a graph capture on a pooled stream that was also the
    engine's serving or warm stream, after which ``pin_memory`` in
    ``DeviceRouteEngine._replay`` raised ``CUDA error: invalid argument``
    on every window and warm. Here 16b's stream runs
    beside a loop of class warms on an executor thread, each a whole
    ``_warm_dispatch`` (the eager program, the graph capture, the replay
    through pinned memory, the pinned sets) of a class this snapshot has
    a graph for, those of the stream's cached windows (Bm set) first
    (the standard classes where nothing is captured: the CPU). Raises if
    a warm or the engine failed."""
    import asyncio
    eng = node.device_engine
    loop = asyncio.get_running_loop()
    done = asyncio.Event()
    c0 = eng.captures

    def warm(b, tables, cursors, cls):
        with eng._on(eng._warm_stream):
            eng._warm_dispatch(b, tables, cursors, cls)

    async def warms():
        n, seen = 0, set()
        while not done.is_set():
            b, tables, cursors = eng._built, eng._tables, eng._cursors
            classes = sorted(
                {k[1:6] for k in eng._graphs if k[0] == b.sid}
                or set(eng._std_classes(b)),
                key=lambda c: (c[2] is None, tuple(x or 0 for x in c)))
            cls = classes[n % len(classes)]
            try:
                await loop.run_in_executor(None, warm, b, tables, cursors,
                                           cls)
            except Exception as e:
                raise AssertionError(f"warm-stress: the warm of class {cls} "
                                     f"raised after {n} warms: {e!r}") from e
            n += 1
            seen.add(eng._class_label(cls))
        return n, sorted(seen)

    task = asyncio.ensure_future(warms())
    try:
        b = await _apps_retained_stream(node, late, retained)
    finally:
        done.set()
        n, seen = await task
    if eng.failed is not None:
        raise AssertionError(f"warm-stress: the engine failed: "
                             f"{eng.failed!r}")
    return {"warms": n, "captures": eng.captures - c0, "classes": seen,
            "stream": b}


async def _apps_defer_leg(node, cl, retained: int) -> dict:
    """16c: the governor's readings scripted (this leg only) into the
    overload grade: the c5r/2/# subscription of `cl` has its replay
    parked and counted; the readings back to normal, the sweep that
    unwinds defer_retained replays it."""
    gov, m = node.overload_governor, node.metrics
    want = len(range(2, retained, APPS_RETAINED_GROUPS))
    d0 = m.val("pipeline.overload.retained_deferred")
    saved = (gov.up_sustain, gov.down_sustain)
    reading = {"queue_fill": 0.80}
    gov.sample_signals = lambda: dict(reading)
    gov.up_sustain = gov.down_sustain = 1
    try:
        for _ in range(4):
            node.sweep()
            if gov.grade >= 2:
                break
        grade_in = gov.state()["grade"]
        armed = gov.retained_deferred
        await cl.subscribe("c5r/2/#", qos=0)
        parked = await _recv_all(cl)
        deferred = m.val("pipeline.overload.retained_deferred") - d0
        # back to normal: sweeps step the grade down (a re-breach
        # backoff, _down_mult, may ask for several); the sweep that
        # unwinds defer_retained drains the parked replay
        reading["queue_fill"] = 0.0
        sweeps = 0
        while gov.retained_deferred and sweeps < 256:
            node.sweep()
            sweeps += 1
        t0 = time.perf_counter()
        drained = await _recv_all(cl)
        drain_s = time.perf_counter() - t0
        for _ in range(256):
            if gov.grade == 0:
                break
            node.sweep()
        grade_out = gov.state()["grade"]
    finally:
        del gov.sample_signals          # the class's own readings again
        gov.up_sustain, gov.down_sustain = saved
    out = {"grade_in": grade_in, "armed": armed, "parked": len(parked),
           "deferred": deferred, "sweeps_to_unwind": sweeps,
           "drained": len(drained), "want": want, "drain_s": drain_s,
           "grade_after": grade_out}
    if grade_in != "overload" or not armed or parked or deferred != 1:
        raise AssertionError(f"phase 16c: overload did not park: {out}")
    if len(drained) != want or not all(x.retain for x in drained):
        raise AssertionError(f"phase 16c: the drain replayed {len(drained)}"
                             f" of {want}")
    return out


async def _apps_operator_leg(node, ports, late: dict, ids: int, nums: int,
                             tmp: str) -> dict:
    """16d: the dashboard's /api/v5 surface, a REST publish, the rewrite
    rule, delayed publish, $SYS, the CLI and flapping detection on the
    booted node."""
    import asyncio

    from emqx_tpu_torch.apps.sys import SysBroker
    from emqx_tpu_torch.mgmt import Cli
    from emqx_tpu_torch.mqtt import constants as C
    srv = node.dashboard_server
    out = {}
    st, body = await _http(srv.port, "POST", "/api/v5/login",
                           {"username": "admin", "password": "public"})
    if st != 200:
        raise AssertionError(f"phase 16d: login answered {st}")
    tok = body["token"]
    cuda = node.device.type == "cuda"
    eps = {}
    for name in ("stats", "trace", "memory", "latency", "overload"):
        st, body = await _http(srv.port, "GET", f"/api/v5/pipeline/{name}",
                               bearer=tok)
        eps[name] = st
        if st != 200:
            raise AssertionError(f"phase 16d: pipeline/{name} answered {st}")
        if name == "stats":
            out["snapshot_sections"] = sorted(body)
        if name == "trace":
            out["trace_windows"] = body["ring"]["windows"]
            if body["ring"]["windows"] <= 0:
                raise AssertionError("phase 16d: no window in the trace")
        if name == "memory":
            out["accounted_fraction"] = body.get("accounted_fraction")
            if cuda and not 0 < (body.get("accounted_fraction") or 0) <= 1:
                raise AssertionError(f"phase 16d: memory accounted "
                                     f"{body.get('accounted_fraction')}")
        if name == "overload":
            out["grade"] = body["state"]["grade"] if "state" in body \
                else body.get("grade")
    st, doc = await _http(srv.port, "GET",
                          "/api/v5/pipeline/trace?format=perfetto",
                          bearer=tok)
    out["perfetto_events"] = len(doc["traceEvents"]) if st == 200 else None
    if st != 200 or not out["perfetto_events"]:
        raise AssertionError(f"phase 16d: perfetto answered {st}")
    out["pipeline"] = eps
    # a REST publish, the rewrite rule, delayed publish
    sub, pub = late["op-sub"], late["op-pub"]
    for f in ("op/rest", "rw/dst/#", "rw/src/#", "dl/#"):
        await sub.subscribe(f, qos=1)
    st, body = await _http(srv.port, "POST", "/api/v5/mqtt/publish",
                           {"topic": "op/rest", "payload": "r", "qos": 1},
                           bearer=tok)
    await pub.publish("rw/src/x", b"w", qos=1)
    got = [(x.topic, x.payload.decode()) for x in await _recv_all(sub)]
    out["rest_publish"] = [st, body, got]
    if st != 200 or got != [("op/rest", "r"), ("rw/dst/x", "w")]:
        raise AssertionError(f"phase 16d: REST publish / rewrite "
                             f"{out['rest_publish']}")
    # the timers sweep every 1 s: a message due at 2 s fires by 3 s
    t0 = time.perf_counter()
    await pub.publish(f"$delayed/{APPS_DELAY_S}/dl/x", b"d", qos=1)
    early = await _recv_all(sub, idle_s=APPS_DELAY_S - 0.2,
                            limit=APPS_DELAY_S - 0.2)
    arrived, after_s = [], None
    try:
        x = await sub.recv(timeout=2.0)
        after_s = time.perf_counter() - t0
        arrived = [(y.topic, y.payload.decode())
                   for y in [x] + await _recv_all(sub)]
    except asyncio.TimeoutError:
        pass
    out["delayed"] = {"early": len(early), "arrived": arrived,
                      "after_s": after_s}
    if early or arrived != [("dl/x", "d")] \
            or not APPS_DELAY_S <= after_s <= APPS_DELAY_S + 1.2:
        raise AssertionError(f"phase 16d: delayed {out['delayed']}")
    # the routes: the population's distinct filters plus this node's own
    st, body = await _http(srv.port, "GET", "/api/v5/routes?_limit=1",
                           bearer=tok)
    topics = node.router.topics()
    population = sum(t.startswith("device/") for t in topics)
    out["routes"] = {"count": body["meta"]["count"],
                     "population": population}
    if st != 200 or body["meta"]["count"] != len(topics) \
            or population != ids * nums:
        raise AssertionError(f"phase 16d: routes {out['routes']} of "
                             f"{ids * nums} filters")
    # flapping: APPS_FLAP_MAX connect/disconnects ban the clientid (with
    # the governor below overload: pause_connects would refuse them)
    out["waited_s"] = await _below_overload(node)
    rcs = []
    for _ in range(APPS_FLAP_MAX + 1):
        rcs.append(await _boot_conn(node, {}, ports, "tcp", "flapper"))
    t_ban = time.time()
    await asyncio.sleep(max(0.0, t_ban + APPS_BAN_S + 0.05 - time.time()))
    node.sweep()
    out["waited_s"] += await _below_overload(node)
    rcs.append(await _boot_conn(node, {}, ports, "tcp", "flapper"))
    out["flapping"] = rcs
    if rcs != [0] * APPS_FLAP_MAX + [C.RC_BANNED, 0]:
        raise AssertionError(f"phase 16d: flapping CONNACKs {rcs}")
    # $SYS: one pipeline payload per section of the snapshot
    watch = late["op-sys"]
    await watch.subscribe("$SYS/brokers/+/pipeline/#", qos=0)
    sysb = SysBroker(node).load()
    snap = node.pipeline_telemetry.snapshot()
    sysb.publish_stats_metrics()
    sysb.unload()
    got = await _recv_all(watch)
    want = {f"stages/{k}" for k in snap["stages"]} | \
        {f"occupancy/{k}" for k in snap["occupancy"]} | \
        {"compiles", "decisions"} | {
            k for k in ("match_cache", "dedup", "readback", "rebuild",
                        "deliver", "supervise", "trace", "ingress",
                        "memory", "program_costs", "latency", "overload")
            if k in snap}
    seen = [x.topic.split("/pipeline/", 1)[1] for x in got]
    out["sys"] = {"payloads": len(seen), "sections": len(want)}
    if sorted(seen) != sorted(want):
        raise AssertionError(f"phase 16d: $SYS pipeline topics "
                             f"{sorted(set(seen) ^ want)} differ")
    # the CLI
    cli = Cli(node)
    trace_dir = os.path.join(tmp, "device-trace")
    out["cli"] = [await cli.run(["status"]),
                  await cli.run(["trace", "device", "start", trace_dir])]
    await pub.publish("op/rest", b"traced", qos=1)
    out["cli"].append(await cli.run(["trace", "device", "stop"]))
    await _recv_all(sub, idle_s=0.2)
    if "is running" not in out["cli"][0] or out["cli"][1:] != [
            "device trace started", "device trace stopped"]:
        raise AssertionError(f"phase 16d: cli {out['cli']}")
    return out


def apps_drive(dev, n_filters: int = PART_FILTERS,
               n_sub: int = E2E_SUB_CONNS, n_pub: int = E2E_PUB_CONNS,
               total: int = APPS_MSGS, retained: int = APPS_RETAINED,
               pin_device: bool = False, warm_stress: bool = False) -> dict:
    """Phase 16: the shipped file booted with its apps (``Node.
    from_config_file`` on `dev`, ``start_listeners``, ``start_apps``,
    ``start_dashboard``, ``start_timers(1.0)``) under ``apps_override``:
    16a phase 8's population and a flood with every 8th PUBLISH retained,
    16b the retained replay at CONFIG5_10M.json's size, 16c the
    governor's defer_retained, 16d the operator surface. ``pin_device``
    pins the chooser (a CPU rehearsal only); ``warm_stress`` runs 16a,
    then ``_apps_warm_stress`` in place of 16b-16d. Raises on any failed
    check."""
    import asyncio
    import shutil
    import tempfile

    from emqx_tpu_torch.apps.retainer import Retainer
    from emqx_tpu_torch.apps.topic_metrics import TopicMetrics
    from emqx_tpu_torch.broker import channel as CH
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.utils.tls import generate_self_signed
    tmp = tempfile.mkdtemp(prefix="emqx-apps-")

    async def run():
        out = {}
        certs = generate_self_signed(os.path.join(tmp, "certs"),
                                     cn="localhost")
        path = os.path.join(tmp, "emqx.conf")
        shutil.copy(BOOT_CONF, path)
        with open(os.path.join(tmp, "emqx_override.conf"), "w") as fh:
            fh.write(apps_override(certs))
        node = Node.from_config_file(path, device=dev)
        clients = []
        try:
            t0 = time.time()
            await node.start_listeners()
            apps = await node.start_apps()
            srv = await node.start_dashboard()
            node.start_timers(1.0)
            ports = _boot_ports(node)
            out["apps"] = [type(a).__name__ for a in apps]
            want_apps = ["Retainer", "DelayedPublish", "TopicRewrite",
                         "TopicMetrics", "FlappingDetect"]
            if out["apps"] != want_apps or srv is None:
                raise AssertionError(f"phase 16a: started {out['apps']}, "
                                     f"dashboard {srv}")
            # every client of 16a-16d but the flapper connects before
            # any load: under load (the population's subscriptions among
            # it) the governor may pause CONNECTs (pause_connects)
            pubs = []
            for p in range(n_pub):
                cl = Client(port=ports["tcp"], clientid=f"apub{p}")
                await cl.connect()
                pubs.append(cl)
            clients += pubs
            late = {}
            for cid in APPS_LATE_CLIENTS:
                cl = Client(port=ports["tcp"], clientid=cid, proto_ver=5)
                await cl.connect()
                late[cid] = cl
            clients += list(late.values())
            parked0 = node.metrics.val("pipeline.overload.retained_deferred")
            subs, ids, nums, n_shared, n_entries = \
                await _subscribe_population(ports["tcp"], n_filters, n_sub)
            clients += subs
            if pin_device:
                node.publish_batcher._device_worth_it = lambda: True
            log(f"phase 16a: subscribed in {time.time() - t0:.1f} s")
            a = {"filters": ids * nums, "shared_filters": n_shared,
                 "publishers": n_pub,
                 "subscriptions": n_entries, "setup_s": time.time() - t0,
                 "hooks": {h: len(node.hooks.lookup(h)) for h in (
                     "message.publish", "message.delivered",
                     "session.subscribed", "client.disconnected")}}
            t0 = time.time()
            await _warm_up(node, pubs[0], subs, nums)
            a["warm_up_s"] = time.time() - t0
            # a subscription made while the governor had defer_retained
            # armed has its replay parked until the sweep after recovery
            # (the reference's semantics); run mid-flood it would deliver
            # what the flood retained by then: the parked replays (of an
            # empty store) drain before the flood
            a["parked_replays"] = node.metrics.val(
                "pipeline.overload.retained_deferred") - parked0
            a["governor_wait_s"] = await _below_overload(node)
            if node.get_app(Retainer)._deferred:
                raise AssertionError("phase 16a: parked retained replays "
                                     "outlived the governor's recovery")
            tm = node.get_app(TopicMetrics)
            tm0 = tm.metrics()
            ret = node.get_app(Retainer)
            r0 = ret.retained_count()
            gc.collect()
            gc.freeze()
            rows, orig, counted = _burst_counter()
            CH.Channel.handle_publish_burst = counted
            try:
                f = await _boot_flood(node, subs, pubs, ids, nums, total,
                                      SEED, where="phase 16a",
                                      retain_every=APPS_RETAIN_EVERY)
            finally:
                CH.Channel.handle_publish_burst = orig
            f["burst_share"] = sum(rows.values()) / f["sent"]
            f.pop("got")
            per_pub = total // n_pub
            pairs = [flood_pairs(SEED, p, per_pub, ids, nums)
                     for p in range(n_pub)]
            to_tm = {APPS_TM_FILTERS[0]: sum(i == 0 for ps in pairs
                                             for i, _n in ps),
                     APPS_TM_FILTERS[1]: sum(n == 0 for ps in pairs
                                             for _i, n in ps)}
            kept = {pr for ps in pairs for k, pr in enumerate(ps)
                    if k % APPS_RETAIN_EVERY == 0}
            tm1 = tm.metrics()
            a["topic_metrics"] = {
                t: {k: v - tm0[t][k] for k, v in c.items() if v - tm0[t][k]}
                for t, c in tm1.items()}
            a["topic_metrics_sent"] = to_tm
            a["retained"] = ret.retained_count() - r0
            a["retained_sent"] = len(kept)
            a["flood"] = f
            if a["retained"] != len(kept) or \
                    node.stats.sample()["retained.count"] != r0 + len(kept):
                raise AssertionError(f"phase 16a: {a['retained']} retained "
                                     f"of {len(kept)} topics")
            for t, n in to_tm.items():
                got = a["topic_metrics"][t]
                if got.get("messages.in", 0) != n \
                        or got.get("messages.out", 0) != n:
                    raise AssertionError(f"phase 16a: topic metrics {t} "
                                         f"{got} for {n} messages")
            a["supervise"] = check_supervised(node, "phase 16a")
            out["a"] = a
            log(f"phase 16a: {f['sent']} msgs {f['per_sec']} msgs/s, share "
                f"{f['device_share']:.4f}, batch_form {f['batch_form']}; "
                f"setup {a['setup_s']:.1f} s, warm-up {a['warm_up_s']:.1f} "
                f"s")
            # (the population stays frozen: a full collection over it
            # stalls the loop for seconds and arms the governor)
            if warm_stress:
                out["warm_stress"] = await _apps_warm_stress(node, late,
                                                             retained)
            else:
                b = await _apps_retained_stream(node, late, retained)
                # 16c between the stream and the replays: its scripted
                # recovery leaves the governor at normal (and its
                # re-breach backoff reset) for them
                out["c"] = await _apps_defer_leg(node, late["c5-defer"],
                                                 retained)
                out["b"] = await _apps_replay(node, ports, late, retained,
                                              b)
                out["d"] = await _apps_operator_leg(node, ports, late, ids,
                                                    nums, tmp)
        finally:
            gc.unfreeze()
            await _boot_stop(node, clients)
        if node.dashboard_server is not None:
            raise AssertionError("phase 16: stop_listeners left the "
                                 "dashboard serving")
        return out

    try:
        return asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def apps_phase(dev, card: str, batch_form_15a=None) -> dict:
    """Phase 16 on the card; prints its lines."""
    t0 = time.time()
    r = apps_drive(dev)
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    f = a["flood"]
    log(f"phase 16a: booted etc/emqx.conf with apps {r['apps']}, the "
        f"dashboard and the 1 s timers; {a['filters']} filters "
        f"({a['shared_filters']} shared) subscribed over TCP, setup "
        f"{a['setup_s']:.1f} s, warm-up {a['warm_up_s']:.1f} s; "
        f"{a['parked_replays']} retained replays parked by the governor "
        f"while subscribing, drained {a['governor_wait_s']:.1f} s after "
        f"the warm-up; hooks {a['hooks']}")
    log(f"phase 16a: {f['sent']} PUBLISHes from {a['publishers']} "
        f"TCP publishers (every 4th QoS 1, every {APPS_RETAIN_EVERY}th "
        f"retained), the message.publish fold live: {f['per_sec']} msgs/s, "
        f"every message once and in order; client p50 "
        f"{f['lat_p50_ms']:.1f} / p99 {f['lat_p99_ms']:.1f} ms; device "
        f"share {f['device_share']:.4f} over {f['windows']} windows "
        f"({f['batches']} batches); burst share {f['burst_share']:.3f}; "
        f"{card}")
    log(f"phase 16a: batch_form (the fold) p50 / p99 "
        f"{f['batch_form']['p50_us']} / {f['batch_form']['p99_us']} us over "
        f"{f['batch_form']['count']} batches; phase 15a's in this run "
        f"{batch_form_15a}")
    log(f"phase 16a: launches {f['launches']}; a window: shape_match "
        f"{_shape_rates(f['fold_shapes'], f['windows'])}, prefix_sum "
        f"{_shape_rates(f['scan_shapes'], f['windows'])}")
    log(f"phase 16a: retained {a['retained']} topics (sent "
        f"{a['retained_sent']}); topic metrics {a['topic_metrics']} for "
        f"{a['topic_metrics_sent']} sent")
    log(f"phase 16b: {b['retained']} retained PUBLISHes stored in "
        f"{b['publish_s']:.2f} s ({b['publish_per_sec']} msgs/s, "
        f"{b['device_messages']} through {b['windows']} device windows, "
        f"launches {b['launches']}); a late c5r/# subscriber "
        f"replayed {b['replayed']} in {b['replay_s']:.2f} s "
        f"({b['replay_per_sec']} msgs/s), all with the retain flag; "
        f"c5r/0/+ got {b['one_group']}, rh 2 got {b['rh2']}; a sweep "
        f"with them stored {b['sweep_s_full']:.3f} s, after clean "
        f"(c5r/#: {b['cleaned']}) {b['sweep_s_after']:.3f} s; waited "
        f"{b['waited_s']:.1f} s for the governor; {card}")
    x = b["stored"]
    log(f"phase 16b: with the {b['retained']} stored, {APPS_HOLD_S} s of "
        f"1 s sweeps (each {x['sweeps_s']} s; full collections "
        f"{x['full_collections_s']} s): governor at most {x['grade_max']}, "
        f"then {x['grade']} "
        f"(loop lag {x['loop_lag_ms']} ms, connects paused "
        f"{x['connects_paused']}); a new CONNECT answered {x['connack']}; "
        f"CONNECTs refused {x['connects_rejected']}, accepts closed "
        f"{x['accepts_paused']} so far (the retained sweep returns at "
        f"once while no entry expires; ROADMAP Queue C); {card}")
    log(f"phase 16b: a window: shape_match "
        f"{_shape_rates(b['fold_shapes'], b['windows'])}, prefix_sum "
        f"{_shape_rates(b['scan_shapes'], b['windows'])}")
    log(f"phase 16c: governor {c['grade_in']} (defer_retained "
        f"{c['armed']}): parked {c['parked']} delivered, "
        f"{c['deferred']} deferred; back to normal, the sweep that unwound "
        f"it ({c['sweeps_to_unwind']} sweeps) replayed {c['drained']} of "
        f"{c['want']} in {c['drain_s']:.2f} s; "
        f"grade after {c['grade_after']}")
    log(f"phase 16d: pipeline endpoints {d['pipeline']}, snapshot sections "
        f"{d['snapshot_sections']}, trace windows {d['trace_windows']}, "
        f"perfetto events {d['perfetto_events']}, memory accounted "
        f"{d['accounted_fraction']}; REST publish and rewrite "
        f"{d['rest_publish']}; delayed {d['delayed']}; routes "
        f"{d['routes']}; $SYS {d['sys']}; cli {d['cli']}; flapping "
        f"CONNACKs {d['flapping']}")
    r["seconds"] = time.time() - t0
    log(f"phase 16: {r['seconds']:.1f} s; {card}")
    return r


def warm_stress_main() -> int:
    """``--warm-stress``: build the kernels, then 16a and 16b's stream
    beside looped class warms (``_apps_warm_stress``); it exits 1 where
    the fault shows (a reproducer, not a phase of the run: no deadline)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from emqx_tpu_torch import native
    from emqx_tpu_torch.ops.build import build
    card = card_line()
    log(build().strip())
    if not native.available():
        raise AssertionError("the host native library did not build")
    w = apps_drive(torch.device("cuda"), warm_stress=True)["warm_stress"]
    x = w["stream"]
    log(f"warm-stress: {w['warms']} class warms ({w['captures']} graph "
        f"captures) of {w['classes']} beside "
        f"{x['retained']} retained PUBLISHes in {x['publish_s']:.2f} s "
        f"({x['windows']} device windows); no warm and no engine "
        f"failed; {card}")
    log(card)
    return 0


# ---------------------------------------------------------------------
# Phase 17: the cluster on the card
# ---------------------------------------------------------------------
CL_MSGS = 8_000                      # 17a's flood (bench's 32,000, cut;
                                     # 16,000 before QUIC)
CL_PUBS_PER_NODE = 4
CL_HEARTBEAT_S = 1.0                 # bench.py:1031-1044's beats
CL_SINGLE_ADDS = 100                 # bench.py:1084-1110
CL_CHAOS_CYCLES = 1                  # two before phase 20 took the time
CL_CHAOS_LAX = 2.0                   # tools/chaos_cluster.py's bounds x2
# 17a, 17c and 17d: a quarter of phase 8's population (158 x 158 = 24,964
# filters; a half before QUIC), 17c: half of 16b's 50,000 retained
CL_FILTERS = E2E_FILTERS // 4
CL_RETAINED = APPS_RETAINED // 2
CL_WAL_OPS = 1_000                   # 17c: route adds and retained sets
CL_RESTORE_MSGS = 2_000              # 17c's floods (4,000 before QUIC)
CL_MESH_MSGS = BOOT_MESH_MSGS        # 17d: 15c's mesh twin's
CL_TIMEOUT_S = 120.0


def _per_node_launches(eng) -> dict:
    """Count the kernel launches each engine's serving dispatches make
    (both engines of an in-process cluster share one card and one
    process-wide counter; their dispatches run one at a time on the
    loop, under the device lock)."""
    from emqx_tpu_torch import device as D
    got = {k: 0 for k in D.LAUNCHES}
    dispatch = eng.dispatch

    def counted(h):
        before = dict(D.LAUNCHES)
        try:
            return dispatch(h)
        finally:
            for k, v in D.LAUNCHES.items():
                got[k] += v - before[k]
    eng.dispatch = counted
    return got


def _count_forwards(cn) -> dict:
    """The forwards a cluster node receives, by kind (the reference counts
    only the ones it sends, ``messages.forward``)."""
    got = {"dispatch": 0, "shared": 0}
    for fn, key in (("broker.dispatch_fwd", "dispatch"),
                    ("shared.deliver_fwd", "shared")):
        handler = cn.rpc.handlers[fn]

        async def counted(*a, _h=handler, _k=key):
            got[_k] += 1
            return await _h(*a)
        cn.rpc.handlers[fn] = counted
    return got


CL_NODE_COUNTERS = ("messages.routed.device",
                    "messages.routed.device.remote_shared",
                    "messages.forward", "routing.device.windows",
                    "routing.device.messages", "routing.host.messages",
                    "routing.device.bypassed")


async def _cluster_pair(dev, n_filters: int, n_sub: int, total: int,
                        seed: int, pin_device: bool) -> dict:
    """17a: two nodes of one process on the card, joined over loopback
    rpc with 1 s heartbeats (bench.py:1031-1044); phase 8's population
    with subscriber connection c on node c % 2 (every group has a member
    on each node); the route sync read as bench.py:1048-1110 reads it;
    the warm-up on each node; `total` PUBLISHes from CL_PUBS_PER_NODE
    publishers on each node, every 4th QoS 1, held to exactly once and
    per-topic order across the cluster (``_flood``). Its steps' seconds
    as ``steps_s``."""
    import asyncio

    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.cluster import ClusterNode
    from emqx_tpu_torch.cluster.cluster import T_ROUTE, T_SHARED
    nodes, cns, clients = [], [], []
    out: dict = {}
    steps = out["steps_s"] = {}
    t_step = time.perf_counter()
    try:
        for k in range(2):
            node = Node(device=dev, name=f"cl{k}@127.0.0.1")
            lst = Listener(node, bind="127.0.0.1", port=0)
            await lst.start()
            node.listeners.append(lst)
            cn = ClusterNode(node, port=0, heartbeat_s=CL_HEARTBEAT_S)
            await cn.start()
            if pin_device:
                node.publish_batcher._device_worth_it = lambda: True
            nodes.append(node)
            cns.append(cn)
        await cns[1].join(*cns[0].address)
        steps["start"] = time.perf_counter() - t_step
        ports = [n.listeners[0].port for n in nodes]
        fwd = [_count_forwards(cn) for cn in cns]
        launches = [_per_node_launches(n.device_engine) for n in nodes]

        # the population over TCP, both nodes; the sync: every node's
        # replicated tables hold every route and every shared member
        base = [cn.store.table(T_ROUTE).count()
                + cn.store.table(T_SHARED).count() for cn in cns]
        t0 = time.perf_counter()
        subs, ids, nums, n_shared, n_entries = \
            await _subscribe_population(ports, n_filters, n_sub)
        clients += subs
        t_sub = time.perf_counter() - t0
        n_plain = ids * nums - n_shared
        want = n_plain + 2 * n_shared
        deadline = time.perf_counter() + CL_TIMEOUT_S
        while time.perf_counter() < deadline:
            if all(cn.store.table(T_ROUTE).count()
                   + cn.store.table(T_SHARED).count() - b >= want
                   for cn, b in zip(cns, base)):
                break
            await asyncio.sleep(0.05)
        t_sync = time.perf_counter() - t0
        # entries each node took from its peer (its own are local applies)
        synced = 2 * want - n_entries
        tables = [{"routes": cn.store.table(T_ROUTE).count(),
                   "shared": cn.store.table(T_SHARED).count(),
                   "trie": len(n.router.wildcards) + len(n.router.exact)}
                  for cn, n in zip(cns, nodes)]
        if any(t["trie"] != ids * nums for t in tables):
            raise AssertionError(f"phase 17a: the route sync did not "
                                 f"converge in {CL_TIMEOUT_S} s: {tables}")
        out["sync"] = {"entries": want, "from_peer": synced,
                       "subscribe_s": t_sub, "wall_s": t_sync,
                       "per_s": synced / t_sync, "tables": tables}

        # single adds on node 0, each until visible on node 1
        class _Drop:
            def deliver(self, tf, msg):
                return True
        b0 = nodes[0].broker
        sid = b0.register(_Drop(), "cl-lat")
        tab1 = cns[1].store.table(T_ROUTE)
        lats, lost = [], 0
        for i in range(CL_SINGLE_ADDS):
            f = f"cl-lat/{i}/+"
            t1 = time.perf_counter()
            b0.subscribe(sid, f)
            await cns[0].flush()
            lim = t1 + 5.0
            while not tab1.lookup(f):
                if time.perf_counter() > lim:
                    lost += 1
                    break
                await asyncio.sleep(0)
            else:
                lats.append(time.perf_counter() - t1)
        lat_ms = np.sort(np.array(lats)) * 1e3
        out["single_add"] = {
            "adds": CL_SINGLE_ADDS, "lost": lost,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99))}
        for i in range(CL_SINGLE_ADDS):
            b0.unsubscribe(sid, f"cl-lat/{i}/+")
        steps["subscribe_sync_adds"] = \
            time.perf_counter() - t_step - steps["start"]

        pubs = []
        for p in range(2 * CL_PUBS_PER_NODE):
            cl = Client(port=ports[p % 2], clientid=f"cpub{p}")
            await cl.connect()
            pubs.append(cl)
        clients += pubs
        t0 = time.perf_counter()
        for k, node in enumerate(nodes):
            await _warm_up(node, pubs[k], subs, nums)
        out["warm_up_s"] = steps["warm_up"] = time.perf_counter() - t0
        snap = []
        for node in nodes:
            b = node.device_engine._built
            remote = list(b.remote_members)
            snap.append({"filters": len(b.fid_filter),
                         "remote_members": len(remote),
                         "remote_origins": sorted({o for o, _s in remote}),
                         "backend": b.backend})
        out["snapshots"] = snap
        if any(s["filters"] != ids * nums or s["remote_members"] != n_shared
               for s in snap):
            raise AssertionError(f"phase 17a: a snapshot lacks filters or "
                                 f"remote members: {snap}")
        gc.collect()
        gc.freeze()
        try:
            c0 = [{k: n.metrics.val(k) for k in CL_NODE_COUNTERS}
                  for n in nodes]
            f0 = [dict(f) for f in fwd]
            l0 = [dict(x) for x in launches]
            f = await _flood(nodes[0], subs, pubs, ids, nums, total, seed,
                             per_topic=True, others=nodes[1:])
            await asyncio.sleep(0.2)
        finally:
            gc.unfreeze()
        per_node = []
        for k, node in enumerate(nodes):
            d = {c: node.metrics.val(c) - v for c, v in c0[k].items()}
            lk = {n: launches[k][n] - l0[k][n] for n in launches[k]}
            wins = max(1, d["routing.device.windows"])
            per_node.append({
                "name": node.name,
                "device_share": d["routing.device.messages"] / max(
                    1, d["routing.device.messages"]
                    + d["routing.host.messages"]),
                "windows": d["routing.device.windows"],
                "bypassed": d["routing.device.bypassed"],
                "forwards_sent": d["messages.forward"],
                "forwards_received": {x: fwd[k][x] - f0[k][x]
                                      for x in fwd[k]},
                "remote_shared": d["messages.routed.device.remote_shared"],
                "launches": lk,
                "launches_per_window": {n: lk[n] / wins for n in lk}})
        out["flood"] = {k: v for k, v in f.items() if k != "got"}
        steps["flood"] = f["wall_s"]
        out["nodes"] = per_node
        out.update(filters=ids * nums, shared_filters=n_shared,
                   subscriptions=n_entries)
        for p in per_node:
            if p["device_share"] < E2E_MIN_DEVICE_SHARE:
                raise AssertionError(f"phase 17a: {p['name']} routed "
                                     f"{p['device_share']:.3f} of its "
                                     f"messages on the device (at least "
                                     f"{E2E_MIN_DEVICE_SHARE}): {p}")
            if p["remote_shared"] <= 0:
                raise AssertionError(f"phase 17a: {p['name']} picked no "
                                     f"remote member on the device: {p}")
            if dev.type == "cuda" and (p["launches"]["shape_match"] <= 0
                                       or p["launches"]["prefix_sum"] <= 0):
                raise AssertionError(f"phase 17a: {p['name']} launched no "
                                     f"kernel 1 or 2: {p['launches']}")
        return out
    finally:
        # the cluster first: the clients' sessions then end without
        # replicating the population's route deletes to the peer
        t_stop = time.perf_counter()
        for cn in cns:
            await cn.stop()
        for cl in clients:
            try:
                await cl.disconnect()
            except Exception:  # noqa: BLE001 — teardown
                pass
        for node in nodes:
            await node.stop_listeners()
            if node.publish_batcher is not None:
                await node.publish_batcher.stop()
                node.publish_batcher.close()
        steps["stop"] = time.perf_counter() - t_stop


def _populate_sessions(node, ids: int, nums: int, n_sub: int):
    """``_populate`` with a persistent session per sink holding the same
    subscriptions in the same order (what a parked client leaves in the
    node): (sinks, sids, sessions)."""
    from emqx_tpu_torch.broker.session import Session, SessionConf
    b = node.broker
    sinks = [_Sink() for _ in range(n_sub)]
    sids = [b.register(s, f"esub{c}") for c, s in enumerate(sinks)]
    sessions = [Session(f"esub{c}", SessionConf(
        session_expiry_interval=3600)) for c in range(n_sub)]
    for c, f, qos, _second in _population(ids, nums, n_sub):
        b.subscribe(sids[c], f, {"qos": qos})
        sessions[c].subscribe(f, {"qos": qos})
    return sinks, sids, sessions


def _restore_flood(eng, topics: list, first: dict, B: int = 1024) -> list:
    """route_batch of B-message windows (the batcher's max_batch); `first`
    gets the launches of the first window (the counts set to 0 just
    before it)."""
    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.message import make
    counts = []
    D.reset_launches()
    for k in range(0, len(topics), B):
        got = eng.route_batch([make(f"p{(k + j) % 8}", 0, t, b"%d" % (k + j))
                               for j, t in enumerate(topics[k:k + B])])
        if got is None:
            raise AssertionError("a restore flood's window was declined")
        counts += got
        if k == 0:
            first.update(D.LAUNCHES)
    return counts


async def _restore(dev, n_filters: int, n_sub: int, total: int,
                   retained: int, wal_ops: int, seed: int) -> dict:
    """17c: a node with phase 8's population (persistent sessions) and
    `retained` retained messages (16b's c5r/{i % 64}/k{i}) snapshots; then
    `wal_ops` route adds and retained sets go to the write-ahead log; a
    fresh node loads the snapshot and replays the log, its clients come
    back over TCP with clean_start false (taking their restored sessions
    over), and the same flood must reach them as it reached the original
    node's sessions; a late c5r/# subscriber replays
    every retained message."""
    import asyncio
    import shutil
    import tempfile

    from emqx_tpu_torch.apps.delayed import DelayedPublish
    from emqx_tpu_torch.apps.retainer import Retainer
    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.broker.persistence import (Persistence,
                                                   attach_retainer_journal)
    from emqx_tpu_torch.client import Client

    def app_node(name):
        node = Node(device=dev, name=name)
        node.register_app(Retainer(node).load())
        node.register_app(DelayedPublish(node).load())
        return node

    ids, nums = e2e_grid(n_filters)
    r = np.random.RandomState(seed)
    topics = [f"device/d{i}/x/n{k}/t" for i, k in zip(
        r.randint(0, ids, total), r.randint(0, nums, total))]
    tmp = tempfile.mkdtemp(prefix="emqx_tpu_torch-17c-")
    out: dict = {}
    nodes, clients = [], []
    try:
        node = app_node("cl-orig@127.0.0.1")
        nodes.append(node)
        sinks, sids, sessions = _populate_sessions(node, ids, nums, n_sub)
        eng = node.device_engine
        eng.rebuild()
        first0: dict = {}
        counts0 = _restore_flood(eng, topics, first0)
        want = _take(sinks)
        for i in range(retained):
            node.broker.publish(make("c5", 0, f"c5r/{i % 64}/k{i}",
                                     b"retained-%d" % i,
                                     flags={"retain": True}))
            if i % 4096 == 4095:
                await asyncio.sleep(0)
        # the clients go: their sessions park, their subscriptions stay
        for c, (sid, sess) in enumerate(zip(sids, sessions)):
            sess.parked_sid = sid
            node.cm.park_session(f"esub{c}", sess)
        pers = Persistence(node, tmp)
        attach_retainer_journal(node)
        t0 = time.perf_counter()
        path = pers.save_snapshot()
        out["save_s"] = time.perf_counter() - t0
        out["snapshot_bytes"] = os.path.getsize(path)
        # after the snapshot: the write-ahead log
        wal_sid = node.broker.register(_Sink(), "wal-sink")
        t0 = time.perf_counter()
        for i in range(wal_ops):
            f = f"wal/r{i}/+"
            node.broker.subscribe(wal_sid, f)
            pers.journal("route_add", topic=f)
            node.broker.publish(make("c5", 0, f"c5r/{i % 64}/k{retained + i}",
                                     b"retained-%d" % (retained + i),
                                     flags={"retain": True}))
        out["wal_s"] = time.perf_counter() - t0
        out["wal_entries"] = pers.wal.count()
        routes = node.router.topics()
        node.publish_batcher.close()
        eng.close() if hasattr(eng, "close") else None

        # the restart
        node2 = app_node("cl-orig@127.0.0.1")
        nodes.append(node2)
        rebuild = node2.router.rebuild
        rb = [0.0]

        def timed_rebuild():
            t = time.perf_counter()
            rebuild()
            rb[0] += time.perf_counter() - t
        node2.router.rebuild = timed_rebuild
        t0 = time.perf_counter()
        loaded = Persistence(node2, tmp).load_snapshot()
        out["load_s"] = time.perf_counter() - t0
        out["router_rebuild_s"] = rb[0]
        del node2.router.rebuild
        ret2 = node2.get_app(Retainer)
        out["restored"] = {"routes": len(node2.router.topics()),
                           "retained": ret2.retained_count(),
                           "sessions": node2.cm.parked_count()}
        if not loaded or node2.router.topics() != routes \
                or ret2.retained_count() != retained + wal_ops \
                or node2.cm.parked_count() != n_sub:
            raise AssertionError(f"phase 17c: the restored state differs: "
                                 f"{out['restored']}, {len(routes)} routes "
                                 f"before")
        # the clients come back: a CONNECT with clean_start false each,
        # which takes its parked session over and re-installs its routes
        # under a new sid (Channel's resume through cm.open_session)
        lst = Listener(node2, bind="127.0.0.1", port=0)
        await lst.start()
        node2.listeners.append(lst)
        t0 = time.perf_counter()
        resumed = []
        for c in range(n_sub):
            cl = Client(port=lst.port, clientid=f"esub{c}",
                        clean_start=False)
            ack = await cl.connect(timeout=CL_TIMEOUT_S)
            clients.append(cl)
            resumed.append(cl)
            if not ack.session_present:
                raise AssertionError(f"phase 17c: esub{c} found no "
                                     f"restored session")
        out["resume_s"] = time.perf_counter() - t0
        if node2.cm.parked_count():
            raise AssertionError(f"phase 17c: {node2.cm.parked_count()} "
                                 f"restored sessions were not taken over")
        eng2 = node2.device_engine
        t0 = time.perf_counter()
        eng2.rebuild()
        out["engine_build_s"] = time.perf_counter() - t0
        first: dict = {}
        counts1 = _restore_flood(eng2, topics, first)
        n_want = [len(w) for w in want]
        got = [[] for _ in range(n_sub)]
        t_end = time.perf_counter() + CL_TIMEOUT_S
        while any(len(g) < n for g, n in zip(got, n_want)) \
                and time.perf_counter() < t_end:
            await asyncio.sleep(0.01)
            for g, cl in zip(got, resumed):
                while not cl.messages.empty():
                    g.append(cl.messages.get_nowait())
        await asyncio.sleep(0.2)         # a duplicate would land by now
        for g, cl in zip(got, resumed):
            while not cl.messages.empty():
                g.append(cl.messages.get_nowait())
        out["first_window_launches"] = first
        out["flood"] = {"msgs": total, "delivered": int(sum(counts1)),
                        "original_delivered": int(sum(counts0)),
                        "received": sum(map(len, got))}
        diff = sum([m.payload for m in g] != [pl for pl, _f in w]
                   or any(m.topic != topics[int(m.payload)] for m in g)
                   for g, w in zip(got, want))
        if diff or counts1 != counts0:
            raise AssertionError(f"phase 17c: the resumed sessions received "
                                 f"otherwise than the original's ({diff} "
                                 f"sessions differ)")
        if dev.type == "cuda" and first.get("shape_match", 0) <= 0:
            raise AssertionError(f"phase 17c: the restored node's first "
                                 f"window launched no kernel 1: {first}")
        # a late subscriber replays every retained message
        cl = Client(port=lst.port, clientid="c5-late")
        await cl.connect()
        t0 = time.perf_counter()
        await cl.subscribe("c5r/#", qos=0, timeout=60)
        n_all, flags = 0, True
        t_end = time.perf_counter() + CL_TIMEOUT_S
        while n_all < retained + wal_ops and time.perf_counter() < t_end:
            try:
                msg = await cl.recv(timeout=5)
            except asyncio.TimeoutError:
                break
            n_all += 1
            flags = flags and bool(msg.retain)
        replay_s = time.perf_counter() - t0
        await cl.disconnect()
        out["replay"] = {"replayed": n_all, "want": retained + wal_ops,
                         "wall_s": replay_s, "per_s": n_all / replay_s,
                         "retain_flag": flags}
        if n_all != retained + wal_ops or not flags:
            raise AssertionError(f"phase 17c: the late subscriber replayed "
                                 f"{n_all} of {retained + wal_ops}")
        return out
    finally:
        for cl in clients:
            try:
                await cl.disconnect()
            except Exception:  # noqa: BLE001 — teardown
                pass
        for node in nodes:
            await node.stop_listeners()
            if node.publish_batcher is not None:
                node.publish_batcher.close()
        shutil.rmtree(tmp, ignore_errors=True)


async def _mesh_under_cluster(dev, n_filters: int, n_sub: int, total: int,
                              seed: int) -> dict:
    """17d: a ``multichip.enable`` node and a single-chip node of one
    process joined in a cluster, phase 8's population split over them
    (session c on node c % 2, every group a member on each), `total`
    messages through the mesh node's route_batch (15c's mesh twin):
    every message once, order per topic at every session, remote picks
    forwarded. The exchange serves no clustered window (the reference
    precludes it, ``emqx_tpu/parallel/serving.py:1371``): kernel 3 runs
    in the exchange class warm under the cluster, and serves again once
    the node leaves."""
    import asyncio

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.config import Config
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.cluster import ClusterNode
    ids, nums = e2e_grid(n_filters)
    conf = Config()
    conf.update(("broker", "multichip"), {
        "enable": True, "devices": MN_DEVICES, "dp": MN_DP}, persist=False)
    mesh = Node(conf, device=dev, name="clm@127.0.0.1")
    single = Node(device=dev, name="cls@127.0.0.1")
    nodes = (mesh, single)
    # every class warm's launches (recorded, serving no traffic), the
    # background warm thread's too
    warm_calls: list = []
    warm_one = mesh.device_engine._warm_one

    def counted_warm(Bp):
        calls = warm_one(Bp)
        warm_calls.extend(calls)
        return calls
    mesh.device_engine._warm_one = counted_warm
    cns = []
    out: dict = {}
    try:
        for node in nodes:
            cn = ClusterNode(node, port=0, heartbeat_s=CL_HEARTBEAT_S)
            await cn.start()
            cns.append(cn)
        await cns[1].join(*cns[0].address)
        sinks = [_Sink() for _ in range(n_sub)]
        sids = [nodes[c % 2].broker.register(s, f"esub{c}")
                for c, s in enumerate(sinks)]
        n_shared = 0
        for k, (c, f, qos, second) in enumerate(
                _population(ids, nums, n_sub)):
            nodes[c % 2].broker.subscribe(sids[c], f, {"qos": qos})
            n_shared += qos == 1 and not second
            if k % 4096 == 4095:
                await asyncio.sleep(0)
        for cn in cns:
            await cn.flush()
        # the replication converged: both nodes' tries hold every filter
        # and the mesh node's table every shared member
        shared_tab = cns[0].store.table("shared")
        for _ in range(int(CL_TIMEOUT_S / 0.05)):
            if len(mesh.router.wildcards) >= ids * nums \
                    and shared_tab.count() >= 2 * n_shared:
                break
            await asyncio.sleep(0.05)
        eng, m = mesh.device_engine, mesh.metrics
        t0 = time.time()
        eng.route_batch([make("w", 0, "warmup/none/t", b"")], wait=True)
        Bp = eng.n_dp
        while Bp <= eng.max_batch:
            eng._warm_one(Bp)
            Bp *= 2
        eng.warm_exchange(eng.max_batch)
        t = eng._warm_thread
        if t is not None:
            t.join()
        out["warm_s"] = time.time() - t0
        out["warm_ring_rotate"] = sum(1 for name, _s in warm_calls
                                      if name == "ring_rotate")
        out["remote_members"] = sum(len(b.remote_members)
                                    for b in eng._builts)
        if out["remote_members"] != n_shared:
            raise AssertionError(f"phase 17d: the mesh snapshot holds "
                                 f"{out['remote_members']} remote members "
                                 f"of {n_shared}")
        r = np.random.RandomState(seed)
        pairs = list(zip(r.randint(0, ids, total), r.randint(0, nums, total)))
        keys = ("pipeline.exchange.windows",
                "pipeline.exchange.fallback.precluded",
                "messages.routed.device.remote_shared",
                "messages.forward")
        c0 = {k: m.val(k) for k in keys}
        D.reset_launches()
        B = eng.max_batch
        t0 = time.perf_counter()
        for k in range(0, total, B):
            eng.route_batch(
                [make(f"p{(k + j) % 8}", 0, f"device/d{i}/x/n{n}/t",
                      b"%d" % (k + j))
                 for j, (i, n) in enumerate(pairs[k:k + B])], wait=True)
            await asyncio.sleep(0)
        for cn in cns:
            await cn.flush()
        deadline = time.perf_counter() + CL_TIMEOUT_S
        while sum(len(s.got) for s in sinks) < total \
                and time.perf_counter() < deadline:
            await asyncio.sleep(0.02)
        dt = time.perf_counter() - t0
        await asyncio.sleep(0.3)
        launches = dict(D.LAUNCHES)
        d = {k: m.val(k) - v for k, v in c0.items()}
        seen = np.zeros(total, np.int64)
        wrong = 0
        for c, s in enumerate(sinks):
            last = {}
            for payload, _f in s.got:
                j = int(payload)
                seen[j] += 1
                i, n = pairs[j]
                own = i % n_sub
                ok = {own, (own + 1) % n_sub} if e2e_shared(i, n, nums) \
                    else {own}
                wrong += c not in ok
                if last.get((i, n), -1) >= j:
                    raise AssertionError(f"phase 17d: esub{c} got topic "
                                         f"({i}, {n}) out of order")
                last[(i, n)] = j
        if (seen != 1).any() or wrong:
            raise AssertionError(
                f"phase 17d: {int((seen == 0).sum())} lost, "
                f"{int((seen > 1).sum())} duplicated, {wrong} misrouted "
                f"of {total}")
        out.update({
            "msgs": total, "per_sec": total / dt,
            "windows": -(-total // B), "launches": launches,
            "exchange_windows": d["pipeline.exchange.windows"],
            "precluded": d["pipeline.exchange.fallback.precluded"],
            "remote_shared": d["messages.routed.device.remote_shared"],
            "forwards_sent": d["messages.forward"]})
        if d["messages.routed.device.remote_shared"] <= 0:
            raise AssertionError(f"phase 17d: no remote pick: {out}")
        if eng.failed is not None:
            raise AssertionError(f"phase 17d: the server failed: "
                                 f"{eng.failed!r}")
        # out of the cluster, the exchange serves the mesh node's windows
        # again (the snapshot still names the departed members: the host
        # picks for them)
        await cns[0].stop()
        cns.pop(0)
        _warm_mesh_exchange(eng, make, lambda n: [
            f"device/d{i}/x/n{k}/t" for i, k in zip(
                r.randint(0, ids, n), r.randint(0, nums, n))], B, m)
        e0 = m.val("pipeline.exchange.windows")
        D.reset_launches()
        for _ in range(4):
            eng.route_batch([make("p", 0, f"device/d{i}/x/n{n}/t", b"x")
                             for i, n in zip(r.randint(0, ids, B),
                                             r.randint(0, nums, B))],
                            wait=True)
        out["standalone"] = {"windows": 4,
                             "exchange_windows":
                             m.val("pipeline.exchange.windows") - e0,
                             "launches": dict(D.LAUNCHES)}
        if dev.type == "cuda" and (out["warm_ring_rotate"] <= 0 or
                                   out["standalone"]["launches"]
                                   ["ring_rotate"] <= 0):
            raise AssertionError(f"phase 17d: kernel 3 was not launched: "
                                 f"{out}")
        return out
    finally:
        for cn in cns:
            await cn.stop()
        for node in nodes:
            if node.publish_batcher is not None:
                node.publish_batcher.close()
            close = getattr(node.device_engine, "close", None)
            if close is not None:
                close()


def cluster_drive(dev, n_filters: int = CL_FILTERS,
                  n_sub: int = E2E_SUB_CONNS, total: int = CL_MSGS,
                  restore_total: int = CL_RESTORE_MSGS,
                  retained: int = CL_RETAINED, wal_ops: int = CL_WAL_OPS,
                  mesh_total: int = CL_MESH_MSGS,
                  cycles: int = CL_CHAOS_CYCLES, seed: int = SEED,
                  pin_device: bool = False) -> dict:
    """Phase 17: 17a the two-node cluster (``_cluster_pair``), 17b the
    chaos drive over three ``python -m emqx_tpu_torch.run_node``
    processes (``emqx_tpu_torch.chaos_cluster``, kill cycles), 17c
    checkpoint and resume (``_restore``), 17d the mesh node under a
    cluster (``_mesh_under_cluster``). ``pin_device`` pins 17a's choosers
    to the device (a CPU rehearsal; never in the measured run)."""
    import asyncio
    import concurrent.futures as cf

    from emqx_tpu_torch import chaos_cluster
    out = {}
    t0 = time.time()
    # 17b's three node processes start (one after another, each joining
    # the seed once it is READY) while 17a runs in this one
    procs: list = []
    ex = cf.ThreadPoolExecutor(1)
    started = ex.submit(chaos_cluster.spawn_nodes, dev.type, procs)
    try:
        out["a"] = asyncio.run(_cluster_pair(dev, n_filters, n_sub, total,
                                             seed, pin_device))
        out["a"]["phase_s"] = time.time() - t0
        t0 = time.time()
        nodes = started.result()
        wait_s = time.time() - t0
        out["b"] = {"cycles": chaos_cluster.run(
            cycles, lax=CL_CHAOS_LAX, device=dev.type, nodes=nodes,
            procs=procs), "lax": CL_CHAOS_LAX, "nodes_wait_s": wait_s}
        out["b"]["phase_s"] = time.time() - t0
    finally:
        ex.shutdown()       # a spawn under way ends before the reap
        chaos_cluster.reap(procs)
    t0 = time.time()
    out["c"] = asyncio.run(_restore(dev, n_filters, n_sub, restore_total,
                                    retained, wal_ops, seed))
    out["c"]["phase_s"] = time.time() - t0
    t0 = time.time()
    out["d"] = asyncio.run(_mesh_under_cluster(dev, n_filters, n_sub,
                                               mesh_total, seed))
    out["d"]["phase_s"] = time.time() - t0
    return out


def cluster_phase(dev, card: str) -> dict:
    """Phase 17 with its lines, each beside the card line."""
    t0 = time.time()
    c = cluster_drive(dev)
    a = c["a"]
    s = a["sync"]
    log(f"phase 17a: {a['filters']} filters ({a['shared_filters']} shared "
        f"in 2-member groups, one member on each node), "
        f"{a['subscriptions']} subscriptions over TCP on 2 nodes; route "
        f"sync {s['from_peer']} entries from the peer in {s['wall_s']:.2f} "
        f"s ({s['per_s']:.0f} routes/s; subscribe {s['subscribe_s']:.2f} "
        f"s); single add p50 {a['single_add']['p50_ms']:.2f} ms, p99 "
        f"{a['single_add']['p99_ms']:.2f} ms ({a['single_add']['lost']} "
        f"lost of {a['single_add']['adds']}); {card}")
    for snap, p in zip(a["snapshots"], a["nodes"]):
        log(f"phase 17a: {p['name']}: snapshot {snap['filters']} filters, "
            f"{snap['remote_members']} remote members "
            f"({snap['backend']}); flood device share "
            f"{p['device_share']:.4f}, {p['windows']} windows, forwards "
            f"sent {p['forwards_sent']}, received "
            f"{p['forwards_received']}, remote_shared "
            f"{p['remote_shared']}; launches a window "
            f"{ {k: round(v, 3) for k, v in p['launches_per_window'].items()} }"
            f"; {card}")
    f = a["flood"]
    log(f"phase 17a: {f['sent']} PUBLISHes from {2 * CL_PUBS_PER_NODE} "
        f"publishers (4 a node), every one delivered once, order per topic "
        f"held: {f['per_sec']} msgs/s, client p50 {f['lat_p50_ms']:.1f} ms, "
        f"p99 {f['lat_p99_ms']:.1f} ms; steps (s) "
        f"{json.dumps({k: round(v, 2) for k, v in a['steps_s'].items()})}; "
        f"17b's three node processes started meanwhile (waited "
        f"{c['b']['nodes_wait_s']:.2f} s after 17a); {card}")
    for cyc in c["b"]["cycles"]:
        log(f"phase 17b: cycle {cyc['cycle']} kill -9 {cyc['victim']}: "
            f"re-homed CONNECT {cyc['connect_s']:.3f} s, PUBACK gap "
            f"{cyc['puback_gap_s']:.3f} s, 3 nodes running again after "
            f"{cyc['to_3_running_s']:.2f} s; invariants 1-6 held (bounds "
            f"x{c['b']['lax']}); {card}")
    r = c["c"]
    log(f"phase 17c: save_snapshot {r['save_s']:.2f} s, "
        f"{r['snapshot_bytes']} bytes; {r['wal_entries']} WAL entries in "
        f"{r['wal_s']:.2f} s; load_snapshot {r['load_s']:.2f} s (the "
        f"router's device tables {r['router_rebuild_s']:.2f} s), engine "
        f"snapshot {r['engine_build_s']:.2f} s; restored {r['restored']}; "
        f"{r['restored']['sessions']} sessions taken over by clean_start "
        f"false CONNECTs in {r['resume_s']:.2f} s; "
        f"{r['flood']['received']} messages received equal the original "
        f"sessions' deliveries; first "
        f"window launches {r['first_window_launches']}; replay "
        f"{r['replay']['replayed']} retained in {r['replay']['wall_s']:.2f} "
        f"s ({r['replay']['per_s']:.0f} msgs/s); {card}")
    d = c["d"]
    log(f"phase 17d: mesh node under a cluster: {d['msgs']} messages in "
        f"{d['windows']} windows, {d['per_sec']:.0f} msgs/s, "
        f"{d['remote_members']} remote members, remote_shared "
        f"{d['remote_shared']}, forwards {d['forwards_sent']}, order per "
        f"topic held; exchange windows {d['exchange_windows']} "
        f"(precluded {d['precluded']}), launches {d['launches']}; kernel 3 "
        f"in the class warm {d['warm_ring_rotate']}; out of the cluster "
        f"{d['standalone']['exchange_windows']} of "
        f"{d['standalone']['windows']} exchange windows, launches "
        f"{d['standalone']['launches']}; {card}")
    log(f"phase 17: {time.time() - t0:.1f} s (17a {a['phase_s']:.1f}, 17b "
        f"{c['b']['phase_s']:.1f}, 17c {r['phase_s']:.1f}, 17d "
        f"{d['phase_s']:.1f}); {card}")
    return c




# ---------------------------------------------------------------------
# Phase 18: the secured node (authn, authz, the rule engine)
# ---------------------------------------------------------------------
SEC_MSGS = 8_000                     # 18a's flood (bench's 32,000, cut;
                                     # 16,000 before QUIC)
SEC_FORBIDDEN = 100                  # 18a: QoS 1 PUBLISHes the ACL denies
SEC_JWT_PUBS = 2                     # publishers that log in with a JWT
SEC_JWT_SECRET = "chip-smoke-phase-18-hs256"
SEC_SCRAM = ("scram-user", "scram-pencil")
SEC_API_MSGS = 64                    # 18c: QoS 1 PUBLISHes after the API's
                                     # rule was made
SEC_TIMEOUT_S = 60.0
SEC_CHAIN = [
    {"mechanism": "password_based", "backend": "built_in_database",
     "user_id_type": "username", "algorithm": "sha256",
     "salt_position": "prefix"},
    {"mechanism": "jwt", "algorithm": "HS256", "secret": SEC_JWT_SECRET},
    {"mechanism": "scram", "algorithm": "sha256"}]
SEC_AUTHZ = {"no_match": "deny", "cache": {"enable": True}, "sources": [
    {"type": "file", "rules": [
        {"permit": "allow", "action": "subscribe",
         "topics": ["device/#", "rules/#"]},
        {"permit": "deny", "action": "publish",
         "topics": ["device/+/forbidden/#"]},
        {"permit": "allow", "action": "publish", "topics": ["device/#"]}]}]}
# r_q1 republishes at QoS 1: the governor may shed QoS 0 on a booted
# node, which would break the exact count
SEC_RULES = [
    {"id": "r_q1",
     "sql": 'SELECT clientid, topic, qos FROM "device/#" WHERE qos = 1',
     "actions": [{"name": "republish", "params": {
         "target_topic": "rules/q1/${clientid}", "target_qos": 1}}]},
    {"id": "r_conn", "sql": 'SELECT clientid FROM "$events/client_connected"',
     "actions": [{"name": "republish", "params": {
         "target_topic": "rules/conn/${clientid}"}}]}]
SEC_API_RULE = {"id": "r_api",
                "sql": 'SELECT topic FROM "device/#" WHERE qos = 1',
                "actions": [{"name": "do_nothing", "params": {}}]}
SEC_COUNTERS = ("client.authenticate", "client.auth.success",
                "client.auth.failure", "client.authorize",
                "client.authorize.cache_hit", "messages.publish",
                "routing.host.messages", "packets.publish.error")


def secure_override(certs: dict) -> str:
    """Phase 15's override plus the dashboard on 127.0.0.1 port 0, the
    authn chain (built-in users, JWT, SCRAM), the file ACL with no_match
    deny and the two rules."""
    return boot_override(certs) + (
        'dashboard { listeners { http { bind = "127.0.0.1", port = 0 } } }\n'
        f"authn {{ enable = true, chain = {json.dumps(SEC_CHAIN)} }}\n"
        f"authz = {json.dumps(SEC_AUTHZ)}\n"
        f"rule_engine {{ rules = {json.dumps(SEC_RULES)} }}\n")


def _sec_password(user: str) -> bytes:
    return f"pw-{user}".encode()


def _jwt_token(claims: dict, secret: str) -> bytes:
    """An HS256 JWT of `claims` (the MQTT password of a JWT login)."""
    import base64
    import hashlib
    import hmac

    def b64(b):
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()
    head = b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = b64(json.dumps(claims).encode())
    sig = b64(hmac.new(secret.encode(), f"{head}.{body}".encode(),
                       hashlib.sha256).digest())
    return f"{head}.{body}.{sig}".encode()


async def _recv_count(cl, n: int, limit: float = SEC_TIMEOUT_S) -> list:
    """Messages a client receives until it has `n`, then until it is idle
    for 0.5 s (a message past `n` would land by then)."""
    import asyncio
    got, t_end = [], time.perf_counter() + limit
    while len(got) < n and time.perf_counter() < t_end:
        try:
            got.append(await cl.recv(timeout=1.0))
        except asyncio.TimeoutError:
            pass
    return got + await _recv_all(cl)


async def _secure_logins(node, ports: dict, n_pub: int) -> tuple:
    """18's logins: the rules/# subscriber first (r_conn republishes every
    later CONNECT to it), the publishers (built-in users, the last
    SEC_JWT_PUBS by JWT), the SCRAM client by the AUTH exchange and its
    re-authentication; then 18b's refused CONNECTs and SUBSCRIBE.
    Returns (rsub, publishers, the SCRAM client, the clientids connected
    after rsub subscribed, numbers)."""
    from emqx_tpu_torch.client import Client, MqttError
    from emqx_tpu_torch.mqtt import constants as C
    from emqx_tpu_torch.mqtt import packet as P
    out = {}
    port = ports["tcp"]
    rsub = Client(port=port, clientid="rsub", username="rsub",
                  password=_sec_password("rsub"), proto_ver=C.MQTT_V5)
    await rsub.connect()
    # QoS 0 subscriptions: the republishes arrive without queueing behind
    # rsub's inflight window; device/+/forbidden/# would receive any
    # denied PUBLISH that got through
    ack = await rsub.subscribe([("rules/#", P.SubOpts(qos=0)),
                                ("device/+/forbidden/#", P.SubOpts(qos=0))])
    if list(ack.reason_codes) != [0, 0]:
        raise AssertionError(f"phase 18: rsub SUBACK {ack.reason_codes}")
    connected, pubs = [], []
    for p in range(n_pub):
        cid = f"spub{p}"
        pw = (_jwt_token({"sub": cid, "exp": int(time.time()) + 3600},
                         SEC_JWT_SECRET)
              if p >= n_pub - SEC_JWT_PUBS else _sec_password(cid))
        cl = Client(port=port, clientid=cid, username=cid, password=pw,
                    proto_ver=C.MQTT_V5)
        await cl.connect()
        pubs.append(cl)
        connected.append(cid)
    t0 = time.perf_counter()
    sc = Client(port=port, clientid="scram0", proto_ver=C.MQTT_V5)
    sc.enable_scram(*SEC_SCRAM)
    ack = await sc.connect()
    out["scram_connect_s"] = time.perf_counter() - t0
    connected.append("scram0")
    if ack.reason_code != 0 or not sc.scram_server_ok:
        raise AssertionError(f"phase 18: SCRAM CONNACK {ack.reason_code}, "
                             f"server signature {sc.scram_server_ok}")
    out["scram_method"] = (ack.properties or {}).get(
        "authentication_method")
    t0 = time.perf_counter()
    if await sc.reauthenticate(*SEC_SCRAM) is not True:
        raise AssertionError("phase 18: the SCRAM re-authentication failed")
    out["scram_reauth_s"] = time.perf_counter() - t0
    # 18b: refused CONNECTs and a SUBSCRIBE outside the ACL
    bad_jwt = _jwt_token({"sub": "x", "exp": int(time.time()) + 3600},
                         "not-the-secret")
    refused = {
        "bad_password_v5": await _boot_conn(
            node, None, ports, "tcp", "x1", username="spub0",
            password=b"wrong"),
        "bad_password_v311": await _boot_conn(
            node, None, ports, "tcp", "x2", username="spub0",
            password=b"wrong", proto_ver=C.MQTT_V4),
        "jwt_bad_signature": await _boot_conn(
            node, None, ports, "tcp", "x3", username="jwt-x",
            password=bad_jwt)}
    bad = Client(port=port, clientid="x4", proto_ver=C.MQTT_V5)
    bad.enable_scram(SEC_SCRAM[0], "wrong")
    try:
        await bad.connect()
    except MqttError:
        pass
    refused["scram_bad_password"] = bad.connack.reason_code \
        if bad.connack is not None else None
    await bad.close()
    want = {"bad_password_v5": C.RC_BAD_USER_NAME_OR_PASSWORD,
            "bad_password_v311": 4, "jwt_bad_signature":
            C.RC_NOT_AUTHORIZED, "scram_bad_password": C.RC_NOT_AUTHORIZED}
    out["refused"] = refused
    if refused != want:
        raise AssertionError(f"phase 18b: CONNACKs {refused}, want {want}")
    ack = await sc.subscribe("secret/#", qos=1)
    out["suback_outside_acl"] = list(ack.reason_codes)
    out["outside_in_router"] = node.router.has_route("secret/#")
    if out["suback_outside_acl"] != [C.RC_NOT_AUTHORIZED] \
            or out["outside_in_router"]:
        raise AssertionError(f"phase 18b: SUBACK {ack.reason_codes}, in "
                             f"the router {out['outside_in_router']}")
    return rsub, pubs, sc, connected, out


async def _secure_api(node, srv, pubs, nums: int) -> dict:
    """18c: the /api/v5/rules surface over the dashboard listener (login,
    create, list, get, update, a refused update, rule_test, delete); the
    rule made there fires on the next window of QoS 1 PUBLISHes."""
    import asyncio
    st, body = await _http(srv.port, "POST", "/api/v5/login",
                           {"username": "admin", "password": "public"})
    if st != 200:
        raise AssertionError(f"phase 18c: login answered {st}")
    tok = body["token"]

    async def api(method, path, body=None):
        return await _http(srv.port, method, "/api/v5" + path, body,
                           bearer=tok)
    out = {}
    st, r = await api("POST", "/rules", SEC_API_RULE)
    out["create"] = st
    st, lst = await api("GET", "/rules")
    out["list"] = (st, [x["id"] for x in lst])
    st, r = await api("GET", "/rules/r_api")
    out["get"] = (st, r["sql"])
    st, r = await api("PUT", "/rules/r_api", {"description": "phase 18c"})
    out["update"] = (st, r["description"])
    st, r = await api("PUT", "/rules/r_api", {"sql": "SELECT"})
    out["bad_update"] = (st, r["code"])
    st, r = await api("POST", "/rule_test", {
        "sql": SEC_RULES[0]["sql"], "context": {
            "clientid": "c0", "topic": "device/d0/x/n0/t", "qos": 1}})
    out["rule_test"] = (st, r["outputs"])
    want = {"create": 201, "list": (200, ["r_api", "r_conn", "r_q1"]),
            "get": (200, SEC_API_RULE["sql"]),
            "update": (200, "phase 18c"), "bad_update": (400, "BAD_SQL"),
            "rule_test": (200, [{"clientid": "c0",
                                 "topic": "device/d0/x/n0/t", "qos": 1}])}
    if out != want:
        raise AssertionError(f"phase 18c: {out}, want {want}")
    acks = [pubs[0].publish_start(f"device/d0/x/n{k % nums}/t", b"api",
                                  qos=1) for k in range(SEC_API_MSGS)]
    await asyncio.wait_for(asyncio.gather(*acks), SEC_TIMEOUT_S)
    st, r = await api("GET", "/rules/r_api")
    out["fired"] = {k: r["metrics"].get(k, 0) for k in (
        "sql.matched", "sql.passed", "actions.success")}
    if set(out["fired"].values()) != {SEC_API_MSGS}:
        raise AssertionError(f"phase 18c: the API's rule read "
                             f"{out['fired']} after {SEC_API_MSGS} QoS 1 "
                             f"PUBLISHes")
    out["delete"] = (await api("DELETE", "/rules/r_api"))[0]
    out["get_after"] = (await api("GET", "/rules/r_api"))[0]
    if (out["delete"], out["get_after"]) != (204, 404):
        raise AssertionError(f"phase 18c: delete {out['delete']}, then GET "
                             f"{out['get_after']}")
    return out


def secure_drive(dev, n_filters: int = PART_FILTERS,
                 n_sub: int = E2E_SUB_CONNS, n_pub: int = E2E_PUB_CONNS,
                 total: int = SEC_MSGS, forbidden: int = SEC_FORBIDDEN,
                 window=(8, 1024), pin_device: bool = False) -> dict:
    """Phase 18: the shipped file booted under ``secure_override``
    (``Node.from_config_file`` on `dev`, ``start_listeners``,
    ``start_apps``: the retainer, delayed, the rule engine, the authn
    chain and the authz sources; ``start_dashboard``,
    ``start_timers(1.0)``). 18a: every client logs in (built-in users,
    JWT, SCRAM), phase 8's population subscribes, a flood with
    `forbidden` denied QoS 1 PUBLISHes mixed in; 18b the refusals; 18c
    the rules API. ``pin_device`` pins the chooser (a CPU rehearsal
    only). Raises on any failed check."""
    import asyncio
    import collections
    import shutil
    import tempfile

    from emqx_tpu_torch.apps.authn import AuthnChain
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.utils.tls import generate_self_signed
    tmp = tempfile.mkdtemp(prefix="emqx-secure-")

    async def run():
        out = {}
        certs = generate_self_signed(os.path.join(tmp, "certs"),
                                     cn="localhost")
        path = os.path.join(tmp, "emqx.conf")
        shutil.copy(BOOT_CONF, path)
        with open(os.path.join(tmp, "emqx_override.conf"), "w") as fh:
            fh.write(secure_override(certs))
        node = Node.from_config_file(path, device=dev)
        m = node.metrics
        clients = []
        try:
            t0 = time.time()
            await node.start_listeners()
            apps = await node.start_apps()
            srv = await node.start_dashboard()
            node.start_timers(1.0)
            ports = _boot_ports(node)
            out["apps"] = [type(a).__name__ for a in apps]
            want_apps = ["Retainer", "DelayedPublish", "RuleEngine",
                         "AuthnChain", "Authz"]
            if out["apps"] != want_apps or srv is None:
                raise AssertionError(f"phase 18: started {out['apps']}, "
                                     f"dashboard {srv}")
            db, _jwt, scram = node.get_app(AuthnChain).authenticators
            for user in ["rsub"] + [f"esub{c}" for c in range(n_sub)] + [
                    f"spub{p}" for p in range(n_pub - SEC_JWT_PUBS)]:
                db.add_user(user, _sec_password(user).decode())
            scram.add_user(*SEC_SCRAM)
            out["enhanced_authn"] = sorted(node.enhanced_authn)
            rsub, pubs, sc, connected, b = await _secure_logins(
                node, ports, n_pub)
            clients += [rsub, *pubs, sc]
            subs, ids, nums, n_shared, n_entries = \
                await _subscribe_population(
                    ports["tcp"], n_filters, n_sub,
                    login=lambda c: {"username": f"esub{c}",
                                     "password": _sec_password(f"esub{c}")})
            clients += subs
            connected += [f"esub{c}" for c in range(n_sub)]
            if pin_device:
                node.publish_batcher._device_worth_it = lambda: True
            a = {"filters": ids * nums, "shared_filters": n_shared,
                 "subscriptions": n_entries, "publishers": n_pub,
                 "jwt_publishers": SEC_JWT_PUBS,
                 "setup_s": time.time() - t0,
                 "hooks": {h: len(node.hooks.lookup(h)) for h in (
                     "message.publish", "client.authenticate",
                     "client.authorize", "client.connected")}}
            log(f"phase 18a: logged in and subscribed in "
                f"{a['setup_s']:.1f} s")
            t0 = time.time()
            await _warm_up(node, pubs[0], subs, nums)
            a["warm_up_s"] = time.time() - t0
            a["governor_wait_s"] = await _below_overload(node)
            r_q1 = node.rule_engine.get_rule("r_q1").metrics
            q0 = dict(r_q1.counters)
            c0 = {k: m.val(k) for k in SEC_COUNTERS}
            gc.collect()
            gc.freeze()
            f = await _boot_flood(node, subs, pubs, ids, nums, total,
                                  SEED + 18, where="phase 18a",
                                  forbidden=forbidden)
            f.pop("got")
            a["flood"] = f
            a["counters"] = {k: m.val(k) - v for k, v in c0.items()}
            a["r_q1"] = {k: v - q0.get(k, 0)
                         for k, v in r_q1.counters.items()}
            q1 = f["q1_sent"]
            want_q1 = {"sql.matched": f["sent"], "sql.passed": q1,
                       "sql.failed": f["sent"] - q1,
                       "sql.failed.no_result": f["sent"] - q1,
                       "actions.success": q1}
            if a["r_q1"] != want_q1:
                raise AssertionError(f"phase 18a: r_q1 read {a['r_q1']}, "
                                     f"want {want_q1}")
            # the known answer at rules/#: every QoS 1 flood message once,
            # under its publisher's clientid, and one rules/conn/<id> for
            # each CONNECT after rsub subscribed; no denied PUBLISH
            per_pub = total // n_pub
            want_rules = collections.Counter(
                {f"rules/q1/spub{p}": len(range(0, per_pub, 4))
                 for p in range(n_pub)})
            want_rules.update(f"rules/conn/{cid}" for cid in connected)
            got = await _recv_count(rsub, sum(want_rules.values()))
            a["rules_received"] = len(got)
            a["rules_want"] = sum(want_rules.values())
            if collections.Counter(x.topic for x in got) != want_rules:
                extra = collections.Counter(x.topic for x in got)
                extra.subtract(want_rules)
                raise AssertionError(
                    f"phase 18a: rules/# received {len(got)}, want "
                    f"{a['rules_want']}; off by "
                    f"{ {k: v for k, v in extra.items() if v} }")
            a["forbidden"] = collections.Counter(f["forbidden_rcs"])
            if f["forbidden_rcs"] != [0x87] * forbidden:
                raise AssertionError(f"phase 18b: PUBACKs of the denied "
                                     f"PUBLISHes {a['forbidden']}")
            # each republish is routed once on the host (publish_soon ->
            # publish_async), apart from the flood's own messages
            a["republish_host_routes"] = \
                a["counters"]["messages.publish"] - f["sent"]
            if a["republish_host_routes"] != q1:
                raise AssertionError(
                    f"phase 18a: {a['republish_host_routes']} republishes "
                    f"routed for {q1} QoS 1 messages")
            a["window_err"] = e2e_window_check(node, ids, nums, SEED + 19,
                                               *window)
            a["supervise"] = check_supervised(node, "phase 18a")
            out["a"], out["b"] = a, b
            out["c"] = await _secure_api(node, srv, pubs, nums)
            out["counters"] = {k: m.val(k) for k in SEC_COUNTERS}
        finally:
            gc.unfreeze()
            await _boot_stop(node, clients)
        return out

    try:
        return asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def secure_phase(dev, card: str, f15a=None, f16a=None) -> dict:
    """Phase 18 on the card; prints its lines (15a's and 16a's flood
    numbers of the same call beside 18a's)."""
    t0 = time.time()
    r = secure_drive(dev)
    a, b, c = r["a"], r["b"], r["c"]
    f = a["flood"]
    log(f"phase 18a: booted etc/emqx.conf with apps {r['apps']} (enhanced "
        f"authn {r['enhanced_authn']}); {a['filters']} filters "
        f"({a['shared_filters']} shared) subscribed over TCP by logged-in "
        f"clients, setup {a['setup_s']:.1f} s, warm-up "
        f"{a['warm_up_s']:.1f} s; hooks {a['hooks']}")
    log(f"phase 18a: {f['sent']} PUBLISHes from {a['publishers']} TCP "
        f"publishers ({a['jwt_publishers']} by JWT; every 4th QoS 1) and "
        f"{len(f['forbidden_rcs'])} denied QoS 1 PUBLISHes, authz and both "
        f"rules in force: {f['per_sec']} msgs/s, every allowed message "
        f"once and in order; client p50 {f['lat_p50_ms']:.1f} / p99 "
        f"{f['lat_p99_ms']:.1f} ms; device share {f['device_share']:.4f} "
        f"over {f['windows']} windows ({f['batches']} batches); {card}")
    for label, g in (("15a", f15a), ("16a", f16a)):
        if g is not None:
            log(f"phase 18a: beside phase {label} in this run: "
                f"{g['per_sec']} msgs/s, batch_form {g['batch_form']}")
    log(f"phase 18a: batch_form (the fold, r_q1's SQL a message) p50 / p99 "
        f"{f['batch_form']['p50_us']} / {f['batch_form']['p99_us']} us over "
        f"{f['batch_form']['count']} batches")
    log(f"phase 18a: r_q1 {a['r_q1']}; rules/# received "
        f"{a['rules_received']} (the known answer {a['rules_want']}); "
        f"republishes routed on the host {a['republish_host_routes']}, the "
        f"flood's host-routed messages "
        f"{a['counters']['routing.host.messages']}")
    log(f"phase 18a: counters over the flood {a['counters']}")
    log(f"phase 18a: launches {f['launches']}; a window: shape_match "
        f"{_shape_rates(f['fold_shapes'], f['windows'])}, prefix_sum "
        f"{_shape_rates(f['scan_shapes'], f['windows'])}; two engine "
        f"windows == plain path (max |diff| {a['window_err']})")
    log(f"phase 18b: refused CONNACKs {b['refused']}; SUBACK outside the "
        f"ACL {b['suback_outside_acl']} (in the router: "
        f"{b['outside_in_router']}); denied PUBLISHes' PUBACKs "
        f"{dict(a['forbidden'])}, none routed or delivered; SCRAM "
        f"({b['scram_method']}) CONNECT {b['scram_connect_s']:.4f} s, "
        f"re-authentication {b['scram_reauth_s']:.4f} s")
    log(f"phase 18c: /api/v5/rules {c}")
    log(f"phase 18: counters over the phase {r['counters']}")
    r["seconds"] = time.time() - t0
    log(f"phase 18: {r['seconds']:.1f} s; {card}")
    return r




# ---------------------------------------------------------------------
# Phase 19: the database-backed node (the DB arms of authn and authz, a
# data_to_* rule action, the MQTT bridge)
# ---------------------------------------------------------------------
DB_MSGS = 8_000                      # 19a's flood (bench's 32,000, cut;
                                     # 16,000 before QUIC)
DB_FORBIDDEN = 100                   # 19a: QoS 1 PUBLISHes the ACL denies
DB_BRIDGE_UP = 1_000                 # 19b: forwarded with the remote up
DB_BRIDGE_DOWN = 500                 # 19b: queued while it is down
DB_BRIDGE_IN = 50                    # 19b: the remote's cmd/# PUBLISHes
                                     # (each halved before QUIC)
DB_TIMEOUT_S = 60.0
DB_LDAP_USER = ("lduser", "ld-pencil")
DB_LDAP_DN = "uid=lduser,ou=people,dc=emqx"
DB_SECRETS = {"mysql": "mysql-pw", "pgsql": "pg-pw", "redis": "redis-pw",
              "ldap": "svc-pw"}
DB_COUNTERS = ("client.authenticate", "client.auth.success",
               "client.auth.failure", "client.authorize",
               "client.authorize.cache_hit", "messages.publish",
               "packets.publish.error")


def _db_salt(user: str) -> str:
    return f"salt-{zlib.crc32(user.encode()):08x}"


def _fake_db():
    """``tests/test_torch_fake_db.py`` loaded from its path (an installed
    package named ``tests`` may shadow the repo's directory)."""
    import importlib.util
    name = "chip_smoke_fake_db"
    mod = sys.modules.get(name)
    if mod is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "test_torch_fake_db.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def _db_fakes():
    """Phase 19's database servers (``tests/test_torch_fake_db.py``, in
    this process): MySQL (caching_sha2, the fast path) and PostgreSQL
    (SCRAM-SHA-256) hold the users, Redis the ACL (PostgreSQL's ACL
    table is empty), LDAP one directory user. Each user's row holds a
    salted sha256 hash."""
    import re

    from emqx_tpu_torch.utils import passwd as PW
    fake = _fake_db()
    FakeLdap, FakeMysql = fake.FakeLdap, fake.FakeMysql
    FakePgsql, FakeRedis = fake.FakePgsql, fake.FakeRedis
    users = {"mysql": {}, "pgsql": {}}

    def row(user: str, superuser: bool) -> list:
        salt = _db_salt(user)
        return [PW.hash_password("sha256", _sec_password(user), salt,
                                 "prefix"), salt, "1" if superuser else "0"]

    def add_user(db: str, user: str, superuser: bool = False) -> None:
        users[db][user] = row(user, superuser)

    cols = ["password_hash", "salt", "is_superuser"]

    def mysql_handler(sql, params=None):
        hit = users["mysql"].get(params[0]) if params else None
        return cols, [hit] if hit else []

    def pg_handler(sql):
        # the ACL table holds no row: what Redis leaves open is denied
        if "mqtt_acl" in sql:
            return ["permission", "action", "topic"], []
        m = re.search(r"username = '([^']*)'", sql)
        hit = users["pgsql"].get(m.group(1) if m else "")
        return cols, [hit] if hit else []
    mysql = FakeMysql(username="mqtt", password=DB_SECRETS["mysql"],
                      handler=mysql_handler, plugin="caching_sha2_password",
                      sha2_cached=True)
    pg = FakePgsql(username="postgres", password=DB_SECRETS["pgsql"],
                   auth="scram", handler=pg_handler)
    redis = FakeRedis(password=DB_SECRETS["redis"])
    ldap = FakeLdap(
        binds={"": "", "cn=svc,dc=emqx": DB_SECRETS["ldap"],
               DB_LDAP_DN: DB_LDAP_USER[1]},
        entries=[{"dn": DB_LDAP_DN, "uid": [DB_LDAP_USER[0]]}])
    return {"mysql": mysql, "pgsql": pg, "redis": redis, "ldap": ldap,
            "add_user": add_user}


def db_override(certs: dict, fakes: dict) -> str:
    """Phase 15's override with the objective KNOWN_SLO_MS, plus the
    authn chain (MySQL, PostgreSQL, LDAP), the authz sources (Redis,
    PostgreSQL; no_match deny, the cache on) and r_up, whose action
    data_to_up names the resource the script creates."""
    def at(kind: str) -> dict:
        return {"host": "127.0.0.1", "port": fakes[kind].port}
    user_q = ("SELECT password_hash, salt, is_superuser FROM mqtt_user "
              "WHERE username = ${mqtt-username} LIMIT 1")
    chain = [
        dict(at("mysql"), mechanism="password_based", backend="mysql",
             username="mqtt", password=DB_SECRETS["mysql"], database="mqtt",
             query=user_q, algorithm="sha256", salt_position="prefix",
             pool_size=8),
        dict(at("pgsql"), mechanism="password_based", backend="postgresql",
             username="postgres", password=DB_SECRETS["pgsql"],
             database="mqtt", query=user_q, algorithm="sha256",
             salt_position="prefix", pool_size=8),
        {"mechanism": "password_based", "backend": "ldap",
         "server": f"127.0.0.1:{fakes['ldap'].port}",
         "base_dn": "ou=people,dc=emqx", "filter": "(uid=${mqtt-username})",
         "bind_dn": "cn=svc,dc=emqx", "bind_password": DB_SECRETS["ldap"]}]
    authz = {"no_match": "deny", "cache": {"enable": True}, "sources": [
        dict(at("redis"), type="redis", password=DB_SECRETS["redis"],
             cmd="HGETALL mqtt_acl:%u", pool_size=8),
        dict(at("pgsql"), type="postgresql", username="postgres",
             password=DB_SECRETS["pgsql"], database="mqtt", pool_size=8,
             query="SELECT permission, action, topic FROM mqtt_acl "
                   "WHERE username = '%u'")]}
    rules = [{"id": "r_up", "sql": 'SELECT * FROM "device/#" WHERE qos = 1',
              "actions": [{"name": "data_to_up", "params": {
                  "target_topic": "up/${clientid}", "payload_tmpl": "${id}",
                  "qos": 1}}]}]
    return boot_override(certs) + (
        f"broker.slo_route_p99_ms = {KNOWN_SLO_MS}\n"
        f"authn {{ enable = true, chain = {json.dumps(chain)} }}\n"
        f"authz = {json.dumps(authz)}\n"
        f"rule_engine {{ rules = {json.dumps(rules)} }}\n")


class _RemoteSink:
    """An in-process subscriber of the remote node: (topic, payload)."""

    def __init__(self):
        self.got: list = []

    def deliver(self, topic_filter, msg) -> bool:
        self.got.append((msg.topic, bytes(msg.payload)))
        return True


async def _until(cond, limit: float = DB_TIMEOUT_S) -> float:
    """Poll `cond` every 10 ms; the seconds it took. Raises past
    `limit`."""
    import asyncio
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"not met within {limit} s")
        await asyncio.sleep(0.01)
    return time.perf_counter() - t0


async def _db_bridge(node, remote, rport: int, pub, bsub, tmp: str) -> dict:
    """19b: an MqttBridgeWorker forwards bridge/# under edge/ to the
    remote and takes its cmd/# in under from-cloud/; the remote's
    listener stops mid-stream and comes back on the same port."""
    import asyncio
    import struct

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.resources import MqttBridgeWorker
    out = {}
    edge = _RemoteSink()
    remote.broker.subscribe(remote.broker.register(edge, "cloud-edge"),
                            "edge/#", {"qos": 1})
    bridge = MqttBridgeWorker(node, "edge", {
        "host": "127.0.0.1", "port": rport, "clientid": "bridge-edge",
        "forwards": ["bridge/#"], "forward_mountpoint": "edge/",
        "subscriptions": [{"topic": "cmd/#", "qos": 1}],
        "receive_mountpoint": "from-cloud/",
        "queue_dir": os.path.join(tmp, "bridge-q"),
        "reconnect_interval": 0.2})
    await bridge.start()
    try:
        await _until(lambda: bridge.state == "connected")
        D.reset_launches()
        r0 = node.metrics.val("messages.routed.device")

        async def send(lo: int, hi: int) -> None:
            acks = []
            for k in range(lo, hi):
                acks.append(pub.publish_start(
                    f"bridge/d{k % 64}/t", struct.pack("<I", k), qos=1))
                if len(acks) >= 256:
                    await asyncio.wait_for(asyncio.gather(*acks),
                                           DB_TIMEOUT_S)
                    acks.clear()
            await asyncio.wait_for(asyncio.gather(*acks), DB_TIMEOUT_S)
        t0 = time.perf_counter()
        await send(0, DB_BRIDGE_UP)
        await _until(lambda: len(edge.got) >= DB_BRIDGE_UP
                     and bridge.queue.is_empty())
        out["up_s"] = time.perf_counter() - t0
        # the outage: the remote's listener stops (its connections with
        # it); the next forwards wait in the bridge's disk queue
        rlst = remote.listeners[0]
        await rlst.stop()
        remote.listeners.clear()
        await send(DB_BRIDGE_UP, DB_BRIDGE_UP + DB_BRIDGE_DOWN)
        await _until(lambda: bridge.queue.count() >= DB_BRIDGE_DOWN)
        out["queued_in_outage"] = bridge.queue.count()
        out["remote_during_outage"] = len(edge.got)
        lst = Listener(remote, bind="127.0.0.1", port=rport)
        await lst.start()
        remote.listeners.append(lst)
        t0 = time.perf_counter()
        total = DB_BRIDGE_UP + DB_BRIDGE_DOWN
        await _until(lambda: len(edge.got) >= total
                     and bridge.queue.is_empty())
        out["replay_s"] = time.perf_counter() - t0
        await asyncio.sleep(0.2)         # a duplicate would land by now
        seqs = [struct.unpack("<I", p)[0] for _t, p in edge.got]
        out["remote_got"] = len(seqs)
        out["in_order_once"] = seqs == list(range(total))
        out["topics_ok"] = all(t == f"edge/bridge/d{s % 64}/t"
                               for (t, _p), s in zip(edge.got, seqs))
        if out["queued_in_outage"] != DB_BRIDGE_DOWN \
                or out["remote_during_outage"] != DB_BRIDGE_UP \
                or not out["in_order_once"] or not out["topics_ok"]:
            raise AssertionError(f"phase 19b: the bridge's forward {out}")
        out["launches"] = dict(D.LAUNCHES)
        out["device_routed"] = node.metrics.val("messages.routed.device") \
            - r0
        # ingress: the remote's cmd/# reaches bsub under from-cloud/
        await _until(lambda: bridge.state == "connected")
        for k in range(DB_BRIDGE_IN):
            remote.broker.publish(make("cloud", 1, f"cmd/{k % 8}/c",
                                       b"%d" % k))
        got = await _recv_count(bsub, DB_BRIDGE_IN)
        out["ingress"] = len(got)
        if sorted(int(m.payload) for m in got) != list(range(DB_BRIDGE_IN)) \
                or any(not m.topic.startswith("from-cloud/cmd/")
                       for m in got):
            raise AssertionError(f"phase 19b: bsub got {len(got)} of the "
                                 f"remote's {DB_BRIDGE_IN} cmd/# messages")
        out["info"] = bridge.info()
    finally:
        await bridge.stop()
    return out


def db_drive(dev, n_filters: int = PART_FILTERS,
             n_sub: int = E2E_SUB_CONNS, n_pub: int = E2E_PUB_CONNS,
             total: int = DB_MSGS, forbidden: int = DB_FORBIDDEN,
             window=(8, 1024), pin_device: bool = False) -> dict:
    """Phase 19: the shipped file booted under ``db_override`` on `dev`
    with its database servers in this process: ``start_apps`` creates the
    MySQL, PostgreSQL, Redis and PostgreSQL-ACL resources on
    ``node.resources``; the script adds ``up``, an mqtt resource on a
    second port node (host-only, ``device_route`` false) that r_up's
    ``data_to_up`` publishes to. 19a: phase 8's population subscribes
    through 16 MySQL logins (superusers: authz skips their filters), 8
    publishers log in by PostgreSQL and flood with `forbidden` QoS 1
    PUBLISHes mixed in that the ACL denies (the Redis source has no rule
    for them, the PostgreSQL source none either, no_match deny); 19b the
    bridge; 19c LDAP logins, a wrong MySQL password, and
    ``stop_listeners`` closing every resource. ``pin_device`` pins the
    chooser (a CPU rehearsal only). Raises on any failed check."""
    import asyncio
    import collections
    import shutil
    import tempfile

    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.mqtt import constants as C
    from emqx_tpu_torch.resources.resource import MqttResource
    from emqx_tpu_torch.utils.tls import generate_self_signed
    tmp = tempfile.mkdtemp(prefix="emqx-db-")

    async def run():
        out = {}
        fakes = _db_fakes()
        servers = [fakes[k] for k in ("mysql", "pgsql", "redis", "ldap")]
        for s in servers:
            await s.start()
        subs_u = [f"esub{c}" for c in range(n_sub)]
        pubs_u = [f"spub{p}" for p in range(n_pub)]
        for u in subs_u:
            fakes["add_user"]("mysql", u, superuser=True)
        fakes["add_user"]("mysql", "bsub")
        for u in pubs_u:
            fakes["add_user"]("pgsql", u)
        redis = fakes["redis"]
        for u in pubs_u:
            redis.hashes[f"mqtt_acl:{u}"] = {"device/+/x/#": "publish",
                                            "bridge/#": "publish"}
        redis.hashes["mqtt_acl:bsub"] = {"from-cloud/#": "subscribe"}
        certs = generate_self_signed(os.path.join(tmp, "certs"),
                                     cn="localhost")
        path = os.path.join(tmp, "emqx.conf")
        shutil.copy(BOOT_CONF, path)
        with open(os.path.join(tmp, "emqx_override.conf"), "w") as fh:
            fh.write(db_override(certs, fakes))
        remote = Node({"broker": {"device_route": False}}, device=dev)
        rlst = Listener(remote, bind="127.0.0.1", port=0)
        await rlst.start()
        remote.listeners.append(rlst)
        rport = rlst.port
        ups = _RemoteSink()
        remote.broker.subscribe(remote.broker.register(ups, "cloud-up"),
                                "up/#", {"qos": 1})
        node = Node.from_config_file(path, device=dev)
        m = node.metrics
        c_all = {k: m.val(k) for k in DB_COUNTERS}
        clients, stopped = [], False
        try:
            t0 = time.time()
            await node.start_listeners()
            apps = await node.start_apps()
            node.start_timers(1.0)
            ports = _boot_ports(node)
            out["apps"] = [type(a).__name__ for a in apps]
            want_apps = ["Retainer", "DelayedPublish", "RuleEngine",
                         "AuthnChain", "Authz"]
            if out["apps"] != want_apps:
                raise AssertionError(f"phase 19: started {out['apps']}")
            up = await node.resources.create("up", "mqtt", {
                "host": "127.0.0.1", "port": rport, "clientid": "edge-up"})
            if not isinstance(up, MqttResource) or up.status != "connected":
                raise AssertionError(f"phase 19: the up resource {up.info()}")
            out["resources"] = node.resources.list()
            if any(r["status"] != "connected" for r in out["resources"]):
                raise AssertionError(f"phase 19: resources {out['resources']}")
            connects = collections.Counter()    # who logged in by which db
            pubs = []
            for u in pubs_u:
                cl = Client(port=ports["tcp"], clientid=u, username=u,
                            password=_sec_password(u), proto_ver=C.MQTT_V5)
                await cl.connect()
                pubs.append(cl)
                connects["pgsql"] += 1
            clients += pubs
            bsub = Client(port=ports["tcp"], clientid="bsub",
                          username="bsub", password=_sec_password("bsub"),
                          proto_ver=C.MQTT_V5)
            await bsub.connect()
            clients.append(bsub)
            connects["mysql"] += 1
            ack = await bsub.subscribe("from-cloud/#", qos=1)
            if list(ack.reason_codes) != [1]:
                raise AssertionError(f"phase 19: bsub SUBACK "
                                     f"{ack.reason_codes}")
            subs, ids, nums, n_shared, n_entries = \
                await _subscribe_population(
                    ports["tcp"], n_filters, n_sub,
                    login=lambda c: {"username": f"esub{c}",
                                     "password": _sec_password(f"esub{c}")})
            clients += subs
            connects["mysql"] += n_sub
            if pin_device:
                node.publish_batcher._device_worth_it = lambda: True
            a = {"filters": ids * nums, "shared_filters": n_shared,
                 "subscriptions": n_entries, "publishers": n_pub,
                 "setup_s": time.time() - t0}
            log(f"phase 19a: logged in and subscribed in "
                f"{a['setup_s']:.1f} s")
            t0 = time.time()
            await _warm_up(node, pubs[0], subs, nums)
            a["warm_up_s"] = time.time() - t0
            a["governor_wait_s"] = await _below_overload(node)
            ups.got.clear()
            c0 = {k: m.val(k) for k in DB_COUNTERS}
            gc.collect()
            gc.freeze()
            f = await _boot_flood(node, subs, pubs, ids, nums, total,
                                  SEED + 20, where="phase 19a",
                                  forbidden=forbidden)
            f.pop("got")
            a["flood"] = f
            a["counters"] = {k: m.val(k) - v for k, v in c0.items()}
            # the known answer at the remote: every QoS 1 flood message
            # once, by r_up's data_to_up (its own task a message, so in
            # no particular order), under its publisher's clientid
            q1 = f["q1_sent"]
            per_pub = total // n_pub
            await _until(lambda: len(ups.got) >= q1)
            await asyncio.sleep(0.2)
            a["remote_got"] = len(ups.got)
            a["remote_distinct"] = len({p for _t, p in ups.got})
            want_up = collections.Counter(
                {f"up/spub{p}": len(range(0, per_pub, 4))
                 for p in range(n_pub)})
            if collections.Counter(t for t, _p in ups.got) != want_up \
                    or a["remote_distinct"] != q1:
                raise AssertionError(
                    f"phase 19a: the remote got {a['remote_got']} "
                    f"({a['remote_distinct']} distinct) of {q1}")
            r_up = node.rule_engine.get_rule("r_up").metrics.counters
            a["r_up"] = {k: r_up.get(k, 0) for k in (
                "sql.matched", "sql.passed", "actions.success")}
            if a["r_up"]["sql.passed"] != q1 \
                    or a["r_up"]["actions.success"] != q1:
                raise AssertionError(f"phase 19a: r_up read {a['r_up']}, "
                                     f"want {q1} QoS 1 messages passed "
                                     f"and sent")
            a["forbidden"] = collections.Counter(f["forbidden_rcs"])
            if f["forbidden_rcs"] != [0x87] * forbidden:
                raise AssertionError(f"phase 19a: PUBACKs of the denied "
                                     f"PUBLISHes {a['forbidden']}")
            a["window_err"] = e2e_window_check(node, ids, nums, SEED + 21,
                                               *window)
            a["supervise"] = check_supervised(node, "phase 19a")
            out["a"] = a
            t0 = time.time()
            out["b"] = await _db_bridge(node, remote, rport, pubs[0], bsub,
                                        tmp)
            out["b"]["seconds"] = time.time() - t0
            # 19c: LDAP logins and a wrong MySQL password
            out["c"] = {"governor_wait_s": await _below_overload(node)}
            ld, ldpw = DB_LDAP_USER
            c = {"ldap_ok": await _boot_conn(
                     node, None, ports, "tcp", "ld1", username=ld,
                     password=ldpw.encode()),
                 "ldap_wrong": await _boot_conn(
                     node, None, ports, "tcp", "ld2", username=ld,
                     password=b"wrong"),
                 "mysql_wrong": await _boot_conn(
                     node, None, ports, "tcp", "mw", username="esub0",
                     password=b"wrong")}
            connects["ldap"] += 2
            connects["mysql"] += 1
            want = {"ldap_ok": 0, "ldap_wrong": C.RC_BAD_USER_NAME_OR_PASSWORD,
                    "mysql_wrong": C.RC_BAD_USER_NAME_OR_PASSWORD}
            if c != want:
                raise AssertionError(f"phase 19c: CONNACKs {c}, want {want}")
            out["c"]["connacks"] = c
            await _boot_stop(node, clients)
            stopped = True
            out["c"]["resources_after_stop"] = len(node.resources.instances)
            for s in servers:
                await _until(lambda s=s: s.closed >= s.opened, 10.0)
            out["c"]["connections"] = {
                k: (fakes[k].opened, fakes[k].closed)
                for k in ("mysql", "pgsql", "redis", "ldap")}
            if out["c"]["resources_after_stop"] or any(
                    o != cl for o, cl in out["c"]["connections"].values()):
                raise AssertionError(f"phase 19c: after stop_listeners "
                                     f"{out['c']}")
            # the databases' query counts beside the known answers: one
            # authn query per CONNECT in chain order, one Redis query per
            # authz cache miss, a PostgreSQL ACL query per miss Redis left
            # open (the denied topics), two LDAP sessions a directory login
            cnt = {k: m.val(k) - v for k, v in c_all.items()}
            n_conn = sum(connects.values())
            pg = fakes["pgsql"].queries
            misses = cnt["client.authorize"] - cnt["client.authorize.cache_hit"]
            q = {"mysql_authn": len(fakes["mysql"].prepared),
                 "pgsql_authn": sum("mqtt_user" in s for s in pg),
                 "ldap_sessions": fakes["ldap"].opened,
                 "redis_acl": sum(1 for x in redis.commands
                                  if x[0].upper() == b"HGETALL"),
                 "pgsql_acl": sum("mqtt_acl" in s for s in pg)}
            want_q = {"mysql_authn": n_conn,
                      "pgsql_authn": connects["pgsql"] + connects["ldap"],
                      "ldap_sessions": 2 * connects["ldap"],
                      "redis_acl": misses, "pgsql_acl": forbidden}
            out["queries"] = {"got": q, "want": want_q,
                              "connects": dict(connects),
                              "authz_misses": misses}
            if q != want_q or cnt["client.authenticate"] != n_conn:
                raise AssertionError(f"phase 19: database queries {q}, "
                                     f"want {want_q}; authenticate "
                                     f"{cnt['client.authenticate']} for "
                                     f"{n_conn} CONNECTs")
            out["counters"] = cnt
        finally:
            gc.unfreeze()
            if not stopped:
                await _boot_stop(node, clients)
            await remote.stop_listeners()
            for s in servers:
                await s.stop()
        return out

    try:
        return asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def db_phase(dev, card: str, f18a=None) -> dict:
    """Phase 19 on the card; prints its lines (18a's flood of the same
    call beside 19a's)."""
    t0 = time.time()
    r = db_drive(dev)
    a, b, c = r["a"], r["b"], r["c"]
    f = a["flood"]
    log(f"phase 19a: booted etc/emqx.conf with apps {r['apps']}; resources "
        f"{[(x['id'], x['type'], x['status']) for x in r['resources']]}; "
        f"{a['filters']} filters ({a['shared_filters']} shared) subscribed "
        f"over TCP by 16 MySQL logins, setup {a['setup_s']:.1f} s, warm-up "
        f"{a['warm_up_s']:.1f} s")
    log(f"phase 19a: {f['sent']} PUBLISHes from {a['publishers']} TCP "
        f"publishers logged in by PostgreSQL (every 4th QoS 1) and "
        f"{len(f['forbidden_rcs'])} denied QoS 1 PUBLISHes, the Redis and "
        f"PostgreSQL ACL and r_up in force: {f['per_sec']} msgs/s, every "
        f"allowed message once and in order; client p50 "
        f"{f['lat_p50_ms']:.1f} / p99 {f['lat_p99_ms']:.1f} ms; device "
        f"share {f['device_share']:.4f} over {f['windows']} windows "
        f"({f['batches']} batches); {card}")
    if f18a is not None:
        log(f"phase 19a: beside phase 18a in this run: {f18a['per_sec']} "
            f"msgs/s, batch_form {f18a['batch_form']}")
    log(f"phase 19a: batch_form p50 / p99 {f['batch_form']['p50_us']} / "
        f"{f['batch_form']['p99_us']} us over {f['batch_form']['count']} "
        f"batches; r_up {a['r_up']}; the remote got {a['remote_got']} "
        f"({a['remote_distinct']} distinct ids; the known answer "
        f"{f['q1_sent']}); denied PUBLISHes' PUBACKs {dict(a['forbidden'])}")
    log(f"phase 19a: launches {f['launches']}; a window: shape_match "
        f"{_shape_rates(f['fold_shapes'], f['windows'])}, prefix_sum "
        f"{_shape_rates(f['scan_shapes'], f['windows'])}; two engine "
        f"windows == plain path (max |diff| {a['window_err']})")
    log(f"phase 19a: counters over the flood {a['counters']}")
    log(f"phase 19b: the bridge forwarded {DB_BRIDGE_UP} in "
        f"{b['up_s']:.2f} s, queued {b['queued_in_outage']} with the "
        f"remote's listener down (the remote held {b['remote_during_outage']}"
        f"), replayed in {b['replay_s']:.2f} s: the remote got "
        f"{b['remote_got']}, once and in publish order {b['in_order_once']}; "
        f"{b['device_routed']} routed by the device, launches "
        f"{b['launches']}; ingress {b['ingress']} of {DB_BRIDGE_IN} under "
        f"from-cloud/")
    log(f"phase 19c: CONNACKs {c['connacks']}; after stop_listeners "
        f"{c['resources_after_stop']} resources, connections (opened, "
        f"closed) {c['connections']}")
    log(f"phase 19: database queries {r['queries']['got']} (the known "
        f"answers {r['queries']['want']}; CONNECTs by database "
        f"{r['queries']['connects']}, authz cache misses "
        f"{r['queries']['authz_misses']})")
    log(f"phase 19: counters over the phase {r['counters']}")
    r["seconds"] = time.time() - t0
    log(f"phase 19: {r['seconds']:.1f} s; {card}")
    return r




# ---------------------------------------------------------------------
# Phase 20: extension, export and the protocol gateways (exhook,
# plugins, the Prometheus and StatsD exporters, telemetry, STOMP,
# MQTT-SN, CoAP, LwM2M and, where grpc imports, ExProto)
# ---------------------------------------------------------------------
EXT_MSGS = 8_000                     # 20a's flood (bench's 32,000, cut;
                                     # 16,000 before QUIC)
EXT_STOMP, EXT_SN, EXT_COAP = 8, 4, 2   # 20a's gateway subscribers
EXT_IN = {"stomp": 1_000, "mqttsn": 1_000, "coap": 200}   # 20b
EXT_LWM2M_READS = 100                # 20c
EXT_SCRAPES = 3                      # 20d: /metrics scrapes in the flood
EXT_STATSD_S = 0.5                   # 20d: the StatsD app's interval
EXT_UDP_WINDOW = 16                  # 20b: UDP requests in flight
EXT_RCVBUF = 1 << 22                 # the UDP clients' SO_RCVBUF ask
EXT_TIMEOUT_S = 60.0
EXT_EP = "ep-20"
# 20e: the exhook provider asks for message.publish on these ids' topics
# (device/d{j}/#): one blocking gRPC call a matching message in the
# batcher's fold; on every message of the flood it bounded 20a at ~300
# msgs/s on the card
EXT_HOOK_IDS = range(20, 28)
EXT_PLUGIN = "chip_smoke_phase20_plugin"


def _grpc_version():
    """grpc's version where grpc and protobuf import, else None."""
    try:
        import grpc
        from google import protobuf  # noqa: F401
    except ImportError:
        return None
    return grpc.__version__


def ext_override(certs: dict, hook_port=None, handler_port=None) -> str:
    """Phase 15's override with the objective KNOWN_SLO_MS, plus the
    dashboard on 127.0.0.1 port 0 and the gateway blocks stomp (TCP),
    mqttsn, coap and lwm2m (UDP), all on 127.0.0.1 port 0; with `hook_port` an exhook server there and with
    `handler_port` an exproto block whose ConnectionHandler is there."""
    gw = "".join(f'  {name} {{ bind = "127.0.0.1", port = 0 }}\n'
                 for name in ("stomp", "mqttsn", "coap", "lwm2m"))
    if handler_port is not None:
        gw += ('  exproto { bind = "127.0.0.1", port = 0, adapter_port = 0,'
               f' handler_address = "127.0.0.1:{handler_port}" }}\n')
    out = boot_override(certs) + (
        f"broker.slo_route_p99_ms = {KNOWN_SLO_MS}\n"
        'dashboard { listeners { http { bind = "127.0.0.1", port = 0 } } }\n'
        f"gateway {{\n{gw}}}\n")
    if hook_port is not None:
        servers = [{"name": "p20", "url": f"127.0.0.1:{hook_port}",
                    "failed_action": "deny"}]
        out += f"exhook {{ servers = {json.dumps(servers)} }}\n"
    return out


class _HookProvider:
    """An in-process exhook HookProvider (gRPC): asks for message.publish
    on `topics`, answers every OnMessagePublish with CONTINUE and counts
    them. Only built where grpc imports."""

    def __init__(self, topics: list):
        import threading
        from concurrent import futures

        import grpc

        from emqx_tpu_torch.apps.protos import exhook_pb2 as pb
        self.publishes = 0
        self.calls: dict = {}
        lock = threading.Lock()

        def unary(name, req_cls, answer):
            def handler(request, _ctx):
                with lock:
                    self.calls[name] = self.calls.get(name, 0) + 1
                    if name == "OnMessagePublish":
                        self.publishes += 1
                return answer(request)
            return grpc.unary_unary_rpc_method_handler(
                handler, request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString())
        methods = {
            "OnProviderLoaded": unary(
                "OnProviderLoaded", pb.ProviderLoadedRequest,
                lambda _r: pb.LoadedResponse(hooks=[pb.HookSpec(
                    name="message.publish", topics=topics)])),
            "OnProviderUnloaded": unary(
                "OnProviderUnloaded", pb.ProviderUnloadedRequest,
                lambda _r: pb.EmptySuccess()),
            "OnMessagePublish": unary(
                "OnMessagePublish", pb.MessagePublishRequest,
                lambda _r: pb.ValuedResponse(
                    type=pb.ValuedResponse.CONTINUE))}
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "emqx.exhook.v1.HookProvider", methods),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()


class _ExprotoHandler:
    """A ConnectionHandler that takes every stream and answers nothing
    back: enough for the exproto gateway to boot and stop."""

    def __init__(self):
        from concurrent import futures

        import grpc

        from emqx_tpu_torch.gateway.protos import exproto_pb2 as pb

        def drain(request_iterator, _ctx):
            for _ in request_iterator:
                pass
            return pb.EmptySuccess()
        names = {"OnSocketCreated": pb.SocketCreatedRequest,
                 "OnSocketClosed": pb.SocketClosedRequest,
                 "OnReceivedBytes": pb.ReceivedBytesRequest,
                 "OnTimerTimeout": pb.TimerTimeoutRequest,
                 "OnReceivedMessages": pb.ReceivedMessagesRequest}
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "emqx.exproto.v1.ConnectionHandler", {
                    n: grpc.stream_unary_rpc_method_handler(
                        drain, request_deserializer=c.FromString,
                        response_serializer=pb.EmptySuccess
                        .SerializeToString)
                    for n, c in names.items()}),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()


def _flood_payload(payload: bytes) -> tuple:
    """(publisher, seq) of one of `_flood`'s payloads."""
    import struct
    _t, p, s, _i, _n = struct.unpack("<dIIII", payload)
    return p, s


class _StompSub:
    """A STOMP connection (the port's frame codec) that subscribes one
    destination and keeps every MESSAGE it gets as (publisher, seq) for
    flood payloads, the body otherwise; RECEIPTs resolve their futures."""

    def __init__(self, port: int, name: str):
        self.port, self.name = port, name
        self.got: list = []
        self.receipts: dict = {}

    async def connect(self):
        import asyncio

        from emqx_tpu_torch.gateway.stomp import Frame, FrameParser
        self.Frame = Frame
        self.parser = FrameParser()
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)
        self.connected = asyncio.get_running_loop().create_future()
        self._rx = asyncio.get_running_loop().create_task(self._rx_loop())
        self.send("CONNECT", {"accept-version": "1.2", "login": self.name,
                              "client-id": self.name})
        await asyncio.wait_for(self.connected, EXT_TIMEOUT_S)

    async def _rx_loop(self):
        while True:
            data = await self.reader.read(65536)
            if not data:
                return
            for f in self.parser.feed(data):
                if f.command == "CONNECTED":
                    self.connected.set_result(f)
                elif f.command == "MESSAGE":
                    self.got.append(_flood_payload(f.body)
                                    if len(f.body) == 24 else f.body)
                elif f.command == "RECEIPT":
                    fut = self.receipts.pop(f.headers["receipt-id"], None)
                    if fut is not None:
                        fut.set_result(f)
                else:
                    raise AssertionError(f"phase 20: {self.name} got "
                                         f"{f.command} {f.headers}")

    def send(self, command: str, headers: dict, body: bytes = b""):
        self.writer.write(self.Frame(command, headers, body).encode())

    async def receipt(self, command: str, headers: dict, rid: str):
        import asyncio
        fut = asyncio.get_running_loop().create_future()
        self.receipts[rid] = fut
        self.send(command, dict(headers, receipt=rid))
        await self.writer.drain()
        await asyncio.wait_for(fut, EXT_TIMEOUT_S)

    async def close(self):
        await self.receipt("DISCONNECT", {}, f"{self.name}-bye")
        self._rx.cancel()
        self.writer.close()


def _udp_client(proto_cls, port: int, *args):
    """A connected UDP client endpoint with its receive buffer raised (to
    the host's cap) so a burst the loop has not read yet waits there."""
    import asyncio
    import socket
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, EXT_RCVBUF)
    sock.connect(("127.0.0.1", port))
    return asyncio.get_running_loop().create_datagram_endpoint(
        lambda: proto_cls(*args), sock=sock)


class _SnClient:
    """An MQTT-SN client (the port's codec): REGACKs the gateway's
    REGISTERs, keeps every PUBLISH payload, resolves a PUBACK's future by
    message id and a CONNACK's / REGACK's / SUBACK's by type."""

    def __init__(self, name: str):
        import asyncio
        self.name = name
        self.got: list = []
        self.waits: dict = {}
        self.loop = asyncio.get_running_loop()

    def connection_made(self, transport):
        self.transport = transport

    def error_received(self, exc):
        raise AssertionError(f"phase 20: {self.name}: {exc}")

    def connection_lost(self, exc):
        pass

    def datagram_received(self, data, _addr):
        import struct

        from emqx_tpu_torch.gateway import mqttsn as SN
        t, body = SN.decode(data)
        if t == SN.REGISTER:
            tid, mid = struct.unpack(">HH", body[:4])
            self.send(SN.REGACK, struct.pack(">HH", tid, mid) + b"\x00")
        elif t == SN.PUBLISH:
            payload = body[5:]
            self.got.append(_flood_payload(payload)
                            if len(payload) == 24 else payload)
        elif t == SN.PUBACK:
            mid = struct.unpack(">H", body[2:4])[0]
            fut = self.waits.pop(("ack", mid), None)
            if fut is not None:
                fut.set_result(body[4])
        else:
            fut = self.waits.pop(t, None)
            if fut is not None:
                fut.set_result(body)

    def send(self, t: int, body: bytes = b""):
        from emqx_tpu_torch.gateway import mqttsn as SN
        self.transport.sendto(SN.encode(t, body))

    async def request(self, t: int, body: bytes, reply: int):
        import asyncio
        fut = self.loop.create_future()
        self.waits[reply] = fut
        self.send(t, body)
        return await asyncio.wait_for(fut, EXT_TIMEOUT_S)


class _CoapClient:
    """A CoAP client (the port's codec): keeps every notification's
    payload, resolves a request's future by message id."""

    def __init__(self, name: str):
        import asyncio
        self.name = name
        self.got: list = []
        self.waits: dict = {}
        self.requests: list = []     # requests the server sent (LwM2M)
        self.on_request = None
        self.loop = asyncio.get_running_loop()

    def connection_made(self, transport):
        self.transport = transport

    def error_received(self, exc):
        raise AssertionError(f"phase 20: {self.name}: {exc}")

    def connection_lost(self, exc):
        pass

    def datagram_received(self, data, _addr):
        from emqx_tpu_torch.gateway import coap as CO
        m = CO.decode(data)
        fut = self.waits.pop(m.message_id, None) \
            if m.type == CO.ACK else None
        if fut is not None:
            fut.set_result(m)
        elif m.code >> 5 == 0 and m.code:
            self.requests.append(m)
            if self.on_request is not None:
                self.on_request(m)
        elif m.opt(CO.OPT_OBSERVE) is not None and m.type == CO.NON:
            self.got.append(_flood_payload(m.payload)
                            if len(m.payload) == 24 else m.payload)

    def send(self, m):
        from emqx_tpu_torch.gateway import coap as CO
        self.transport.sendto(CO.encode(m))

    async def request(self, m):
        import asyncio
        fut = self.loop.create_future()
        self.waits[m.message_id] = fut
        self.send(m)
        return await asyncio.wait_for(fut, EXT_TIMEOUT_S)


def _coap_req(code: int, path: list, mid: int, token: bytes,
              query=(), observe=None, payload: bytes = b""):
    from emqx_tpu_torch.gateway import coap as CO
    opts = [(CO.OPT_URI_PATH, seg.encode()) for seg in path]
    opts += [(CO.OPT_URI_QUERY, q.encode()) for q in query]
    if observe is not None:
        opts.append((CO.OPT_OBSERVE, observe))
    return CO.CoapMessage(type=CO.CON, code=code, message_id=mid,
                          token=token, options=opts, payload=payload)


def _exposition_check(text: str) -> dict:
    """One scrape of /metrics: every histogram family's ``_count`` must
    equal its ``+Inf`` bucket (the scrape's one cumulative pass); the
    families by type and the publish counter."""
    types_, counts, infs, values = {}, {}, {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types_[name] = kind
            continue
        if line.startswith("#") or not line:
            continue
        name, _, value = line.rpartition(" ")
        if name.endswith('_bucket{le="+Inf"}'):
            infs[name[:-len('_bucket{le="+Inf"}')]] = value
        elif name.endswith("_count") and types_.get(name[:-6]) \
                == "histogram":
            counts[name[:-6]] = value
        values[name] = value
    hists = [n for n, k in types_.items() if k == "histogram"]
    bad = {n: (counts.get(n), infs.get(n)) for n in hists
           if counts.get(n) is None or counts.get(n) != infs.get(n)}
    if bad:
        raise AssertionError(f"phase 20d: _count != +Inf bucket: {bad}")
    return {"families": len(types_), "histograms": len(hists),
            "observations": sum(int(counts[n]) for n in hists),
            "messages_publish": int(values["emqx_messages_publish"])}


def _ext_plugin_file(tmp: str) -> str:
    """The phase's plugin: a module file whose ``load`` returns an
    instance whose ``unload`` records itself."""
    with open(os.path.join(tmp, EXT_PLUGIN + ".py"), "w") as fh:
        fh.write(
            '"""Phase 20\'s plugin: load(node, conf) -> an instance."""\n'
            "EVENTS = []\n\n\n"
            "class Instance:\n"
            "    def __init__(self, conf):\n"
            "        self.conf = conf\n\n"
            "    def unload(self):\n"
            '        EVENTS.append(("unload", self.conf))\n\n\n'
            "def load(node, conf):\n"
            '    EVENTS.append(("load", node.name, conf))\n'
            "    return Instance(conf)\n")
    return tmp


def _ext_want(seed: int, n_pub: int, per_pub: int, ids: int, nums: int,
              dests: dict) -> tuple:
    """The known answer of each gateway subscriber: the flood's messages
    to device/d{j}/x/n{n}/t for its j, as (publisher, seq) in publish
    order per publisher; and each such message's delivery class (whether
    it also matches a shared group: the consume delivers a window's clean
    messages before its shared ones, so order is held per publisher and
    class, as ``_flood`` holds it)."""
    want = {name: [] for name in dests}
    shared = {}
    by_j = {}
    for name, j in dests.items():
        by_j.setdefault(j, []).append(name)
    for p in range(n_pub):
        for k, (i, n) in enumerate(flood_pairs(seed, p, per_pub, ids,
                                               nums)):
            for name in by_j.get(i, ()):
                want[name].append((p, k))
                shared[(p, k)] = e2e_shared(i, n, nums)
    return want, shared


async def _ext_ingress(node, stomp, sn, co, gwin) -> dict:
    """20b: EXT_IN's STOMP SENDs, MQTT-SN QoS 1 PUBLISHes (each PUBACKed)
    and CoAP POSTs to gw/in/...; the MQTT subscriber gwin must get each
    once. They route as the reference routes them: ``publish_soon`` →
    ``publish_async`` (the host trie, one ``messages.publish`` each),
    never the batcher."""
    import asyncio
    import collections
    import struct

    from emqx_tpu_torch.gateway import coap as CO
    from emqx_tpu_torch.gateway import mqttsn as SN
    m = node.metrics
    keys = ("messages.publish", "routing.host.messages",
            "routing.device.messages", "routing.device.batches")
    c0 = {k: m.val(k) for k in keys}
    t0 = time.perf_counter()
    for k in range(EXT_IN["stomp"]):
        stomp.send("SEND", {"destination": "gw/in/stomp"}, b"s%d" % k)
        if k % 64 == 63:
            await stomp.writer.drain()
    await stomp.receipt("SEND", {"destination": "gw/in/stomp/end"},
                        "in-end")
    t_stomp = time.perf_counter() - t0
    body = await sn.request(SN.REGISTER, struct.pack(">HH", 0, 1)
                            + b"gw/in/mqttsn", SN.REGACK)
    tid = body[:2]
    t0 = time.perf_counter()
    sem = asyncio.Semaphore(EXT_UDP_WINDOW)

    async def sn_pub(k):
        async with sem:
            mid = k + 2
            fut = sn.loop.create_future()
            sn.waits[("ack", mid)] = fut
            sn.send(SN.PUBLISH, bytes([0x20]) + tid + struct.pack(">H", mid)
                    + b"n%d" % k)
            return await asyncio.wait_for(fut, EXT_TIMEOUT_S)
    sn_rcs = await asyncio.gather(*[sn_pub(k)
                                    for k in range(EXT_IN["mqttsn"])])
    t_sn = time.perf_counter() - t0
    t0 = time.perf_counter()

    async def co_post(k):
        async with sem:
            r = await co.request(_coap_req(
                CO.POST, ["mqtt", "gw", "in", "coap"], 1000 + k,
                struct.pack(">H", k), ("c=cpub",), payload=b"c%d" % k))
            return r.code
    co_rcs = await asyncio.gather(*[co_post(k)
                                    for k in range(EXT_IN["coap"])])
    t_co = time.perf_counter() - t0
    n_all = sum(EXT_IN.values()) + 1
    got = []
    deadline = time.perf_counter() + EXT_TIMEOUT_S
    while len(got) < n_all and time.perf_counter() < deadline:
        try:
            got.append(await gwin.recv(timeout=1.0))
        except asyncio.TimeoutError:
            pass
    got += await _recv_all(gwin)
    want = collections.Counter(
        [("gw/in/stomp", b"s%d" % k) for k in range(EXT_IN["stomp"])]
        + [("gw/in/mqttsn", b"n%d" % k) for k in range(EXT_IN["mqttsn"])]
        + [("gw/in/coap", b"c%d" % k) for k in range(EXT_IN["coap"])]
        + [("gw/in/stomp/end", b"")])
    seen = collections.Counter((x.topic, bytes(x.payload)) for x in got)
    out = {"received": len(got), "want": n_all,
           "exactly_once": seen == want,
           "stomp_s": t_stomp, "mqttsn_s": t_sn, "coap_s": t_co,
           "mqttsn_pubacks": dict(collections.Counter(sn_rcs)),
           "coap_codes": dict(collections.Counter(
               f"{c >> 5}.{c & 31:02d}" for c in co_rcs)),
           "counters": {k: m.val(k) - v for k, v in c0.items()}}
    if not out["exactly_once"] or out["mqttsn_pubacks"] != {
            0: EXT_IN["mqttsn"]} or out["coap_codes"] != {
            "2.04": EXT_IN["coap"]}:
        missing = want - seen
        extra = seen - want
        raise AssertionError(
            f"phase 20b: {len(got)} of {n_all} at gw/in/#, "
            f"{sum(missing.values())} missing, {sum(extra.values())} extra; "
            f"PUBACKs {out['mqttsn_pubacks']}, CoAP {out['coap_codes']}")
    c = out["counters"]
    if c["messages.publish"] != n_all or c["routing.host.messages"] \
            or c["routing.device.messages"] or c["routing.device.batches"]:
        raise AssertionError(f"phase 20b: counters {c}: want "
                             f"{n_all} publish_async routes, no batch")
    return out


async def _lwm2m_register(node, port: int) -> tuple:
    """20c's endpoint: a CoAP client that answers every read with a TLV,
    registered as EXT_EP before the population subscribes (its
    lwm2m/{ep}/dn/# subscription is then in the snapshot the card serves,
    not the host-matched overlay); (client, location)."""
    from emqx_tpu_torch.gateway import coap as CO
    from emqx_tpu_torch.gateway.lwm2m import tlv_encode
    gw = node.gateway_registry.lookup("lwm2m")
    _t, dev = await _udp_client(_CoapClient, port, "lwm2m-dev")

    def answer(req):
        path = "/".join(req.uri_path)
        dev.send(CO.CoapMessage(
            type=CO.ACK, code=CO.CONTENT, message_id=req.message_id,
            token=req.token, options=[(CO.OPT_CONTENT_FORMAT,
                                       b"\x2d\x16")],
            payload=tlv_encode([{"kind": "resource", "id": 0,
                                 "value": f"acme {path}"}])))
    dev.on_request = answer
    r = await dev.request(_coap_req(
        CO.POST, ["rd"], 1, b"\x01",
        (f"ep={EXT_EP}", "lt=300", "lwm2m=1.0"), payload=b"</3/0>"))
    if r.code != CO.CREATED or EXT_EP not in gw.sessions:
        raise AssertionError(f"phase 20c: register answered {r.code}")
    return dev, [v.decode() for v in r.opts(CO.OPT_LOCATION_PATH)]


async def _ext_lwm2m(node, dev, loc: list, lwctl, lwup) -> dict:
    """20c: the registered endpoint gets EXT_LWM2M_READS read commands
    lwctl sends to lwm2m/{ep}/dn/cmd (the batcher's windows, the chooser
    held on the device: the card routes them to the endpoint's session),
    answers each GET with a TLV, and every reply reaches lwup on
    lwm2m/{ep}/up/resp once; then the endpoint deregisters."""
    import asyncio
    import collections

    from emqx_tpu_torch.gateway import coap as CO
    m = node.metrics
    gw = node.gateway_registry.lookup("lwm2m")
    reg = await lwup.recv(timeout=EXT_TIMEOUT_S)
    pb = node.publish_batcher
    held = pb._device_worth_it
    pb._device_worth_it = lambda: True
    r0 = m.val("messages.routed.device")
    keys = ("routing.device.batches", "routing.device.messages",
            "routing.host.messages", "routing.device.cold_class",
            "routing.device.bypassed", "routing.device.eager_windows",
            "routing.device.host_delta")
    k0 = {k: m.val(k) for k in keys}
    t0 = time.perf_counter()
    try:
        acks = [lwctl.publish_start(
            f"lwm2m/{EXT_EP}/dn/cmd", json.dumps({
                "reqID": k, "msgType": "read",
                "data": {"path": "/3/0/0"}}).encode(), qos=1)
            for k in range(EXT_LWM2M_READS)]
        await lwctl.drain()
        await asyncio.wait_for(asyncio.gather(*acks), EXT_TIMEOUT_S)
        got = []
        while len(got) < EXT_LWM2M_READS:
            got.append(await lwup.recv(timeout=EXT_TIMEOUT_S))
        dt = time.perf_counter() - t0
    finally:
        pb._device_worth_it = held
    routed = m.val("messages.routed.device") - r0
    windows = {k: m.val(k) - v for k, v in k0.items()}
    replies = [json.loads(x.payload) for x in got]
    ids = collections.Counter(x.get("reqID") for x in replies)
    ok = ids == collections.Counter(range(EXT_LWM2M_READS)) and all(
        x["msgType"] == "read" and x["data"]["code"] == "2.05"
        and x["data"]["content"][0]["value"] == "acme 3/0/0"
        for x in replies)
    r = await dev.request(CO.CoapMessage(
        type=CO.CON, code=CO.DELETE, message_id=2, token=b"\x02",
        options=[(CO.OPT_URI_PATH, b"rd"),
                 (CO.OPT_URI_PATH, loc[1].encode())]))
    dereg = json.loads((await lwup.recv(timeout=EXT_TIMEOUT_S)).payload)
    left = (sorted(gw.sessions),
            node.cm.lookup_channel(f"lwm2m:{EXT_EP}") is not None)
    dev.transport.close()
    out = {"register": json.loads(reg.payload)["msgType"],
           "reads": EXT_LWM2M_READS, "replies": len(replies),
           "replies_ok": ok, "device_routed": routed, "windows": windows,
           "server_requests": len(dev.requests), "seconds": dt,
           "deregister": (r.code == CO.DELETED, dereg["msgType"]),
           "sessions_left": left}
    if not ok or out["register"] != "register" or out["deregister"] != (
            True, "deregister") or left != ([], False) \
            or len(dev.requests) != EXT_LWM2M_READS:
        raise AssertionError(f"phase 20c: {out}")
    if routed < 0.9 * EXT_LWM2M_READS:
        raise AssertionError(f"phase 20c: {routed} of {EXT_LWM2M_READS} "
                             f"commands routed by the device {windows}")
    return out


def ext_drive(dev, n_filters: int = PART_FILTERS,
              n_sub: int = E2E_SUB_CONNS, n_pub: int = E2E_PUB_CONNS,
              total: int = EXT_MSGS, window=(8, 1024)) -> dict:
    """Phase 20: the shipped file booted under ``ext_override`` on `dev`:
    ``start_listeners``, ``start_apps`` (with exhook where grpc imports),
    ``start_gateways`` (stomp, mqttsn, coap, lwm2m; exproto where grpc
    imports), ``start_dashboard`` with ``prometheus.register_api`` on its
    server, ``start_timers(1.0)``; a StatsD app and a telemetry reporter
    aimed at receivers in this process, one plugin loaded from a module
    file. 20a: 8 STOMP, 4 MQTT-SN and 2 CoAP subscribers beside phase 8's
    population, a flood; 20b gateway ingress; 20c LwM2M; 20d the
    exporters, telemetry and the plugin; 20e exhook. The chooser is held
    on the device for 20a's flood and 20c's commands, as phase 11 holds
    it (with exhook on every flood message a free chooser put about half
    of this flood on the host: PERF.md §6). Raises on any failed
    check."""
    import asyncio
    import collections
    import shutil
    import socket
    import struct
    import tempfile

    from emqx_tpu_torch.apps.plugins import Plugins
    from emqx_tpu_torch.apps.prometheus import register_api
    from emqx_tpu_torch.apps.statsd import StatsdApp
    from emqx_tpu_torch.apps.telemetry import Telemetry
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.gateway import coap as CO
    from emqx_tpu_torch.gateway import mqttsn as SN
    from emqx_tpu_torch.mgmt.cli import Cli
    from emqx_tpu_torch.mgmt.httpd import HttpServer
    from emqx_tpu_torch.utils.tls import generate_self_signed
    from emqx_tpu_torch.version import __version__
    tmp = tempfile.mkdtemp(prefix="emqx-ext-")
    grpc_version = _grpc_version()
    grpc_ok = grpc_version is not None
    provider = _HookProvider([f"device/d{j}/#" for j in EXT_HOOK_IDS]) \
        if grpc_ok else None
    handler = _ExprotoHandler() if grpc_ok else None

    async def run():
        out = {"grpc": grpc_version}
        certs = generate_self_signed(os.path.join(tmp, "certs"),
                                     cn="localhost")
        path = os.path.join(tmp, "emqx.conf")
        shutil.copy(BOOT_CONF, path)
        with open(os.path.join(tmp, "emqx_override.conf"), "w") as fh:
            fh.write(ext_override(certs, provider and provider.port,
                                  handler and handler.port))
        node = Node.from_config_file(path, device=dev)
        m = node.metrics
        clients, extra, stopped = [], [], False
        # the receivers: StatsD (UDP) and telemetry (HTTP)
        statsd_got: list = []

        class _StatsdSink:
            def connection_made(self, transport):
                pass

            def datagram_received(self, data, _addr):
                statsd_got.append(data.decode())

            def error_received(self, exc):
                raise AssertionError(f"phase 20d: statsd {exc}")

            def connection_lost(self, exc):
                pass
        ssock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        ssock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, EXT_RCVBUF)
        ssock.bind(("127.0.0.1", 0))
        st_transport, _ = await asyncio.get_running_loop() \
            .create_datagram_endpoint(_StatsdSink, sock=ssock)
        reports: list = []
        tsrv = HttpServer("127.0.0.1", 0)

        async def report(req):
            reports.append(json.loads(req.body))
            return 200, {}
        tsrv.route("POST", "/telemetry", report)
        await tsrv.start()
        sys.path.insert(0, _ext_plugin_file(tmp))
        apps_up = []
        try:
            t0 = time.time()
            await node.start_listeners()
            apps = await node.start_apps()
            gws = await node.start_gateways()
            srv = await node.start_dashboard()
            register_api(srv, node)
            node.start_timers(1.0)
            ports = _boot_ports(node)
            out["apps"] = [type(a).__name__ for a in apps]
            out["gateways"] = node.gateway_registry.list()
            want_apps = ["Retainer", "DelayedPublish"] + (
                ["Exhook"] if grpc_ok else [])
            want_gws = ["stomp", "mqttsn", "coap", "lwm2m"] + (
                ["exproto"] if grpc_ok else [])
            if out["apps"] != want_apps or [
                    type(g).__name__[:-len("Gateway")].lower()
                    for g in gws] != want_gws:
                raise AssertionError(f"phase 20: started {out['apps']}, "
                                     f"gateways {out['gateways']}")
            gw = {n: node.gateway_registry.lookup(n) for n in want_gws}
            st, body = await _http(srv.port, "POST", "/api/v5/login",
                                   {"username": "admin",
                                    "password": "public"})
            tok = body["token"]
            # export: telemetry and the plugin (StatsD just before 20a)
            tele = Telemetry(node, {
                "enable": True, "interval": 3600,
                "url": f"http://127.0.0.1:{tsrv.port}/telemetry"}).load()
            apps_up.append(tele)
            plugins = Plugins(node, {"load": [
                {"name": "phase20", "module": EXT_PLUGIN,
                 "config": {"k": 20}}]})
            loaded = plugins.load_all()
            # 20a's gateway subscribers, connected before the population
            ids, nums = e2e_grid(n_filters)
            dests = {}
            stomps = []
            for c in range(EXT_STOMP):
                s = _StompSub(gw["stomp"].port, f"st{c}")
                await s.connect()
                dests[s.name] = 1 + c
                await s.receipt("SUBSCRIBE", {
                    "id": "0", "destination": f"device/d{1 + c}/x/#"},
                    f"{s.name}-sub")
                stomps.append(s)
            sns = []
            for c in range(EXT_SN):
                _t, s = await _udp_client(_SnClient, gw["mqttsn"].port,
                                          f"sn{c}")
                body = await s.request(SN.CONNECT, bytes([0, 1]) +
                                       struct.pack(">H", 600) +
                                       s.name.encode(), SN.CONNACK)
                j = 1 + EXT_STOMP + c
                dests[s.name] = j
                sub = await s.request(SN.SUBSCRIBE, b"\x00" + struct.pack(
                    ">H", 1) + f"device/d{j}/x/#".encode(), SN.SUBACK)
                if body[0] != 0 or sub[-1] != 0:
                    raise AssertionError(f"phase 20a: {s.name} CONNACK "
                                         f"{body!r} SUBACK {sub!r}")
                sns.append(s)
            coaps = []
            for c in range(EXT_COAP):
                _t, s = await _udp_client(_CoapClient, gw["coap"].port,
                                          f"co{c}")
                j = 1 + EXT_STOMP + EXT_SN + c
                dests[s.name] = j
                r = await s.request(_coap_req(
                    CO.GET, ["mqtt", "device", f"d{j}", "x", "#"], 1,
                    bytes([c + 1]), (f"c={s.name}",), observe=b""))
                if r.code != CO.CONTENT:
                    raise AssertionError(f"phase 20a: {s.name} observe "
                                         f"answered {r.code}")
                coaps.append(s)
            # 20b's and 20c's clients: connected before the population
            _t, snpub = await _udp_client(_SnClient, gw["mqttsn"].port,
                                          "snpub")
            await snpub.request(SN.CONNECT, bytes([0, 1]) +
                                struct.pack(">H", 600) + b"snpub",
                                SN.CONNACK)
            _t, copub = await _udp_client(_CoapClient, gw["coap"].port,
                                          "copub")
            extra += [snpub, copub]
            gwin = Client(port=ports["tcp"], clientid="gwin")
            lwctl = Client(port=ports["tcp"], clientid="lwctl")
            lwup = Client(port=ports["tcp"], clientid="lwup")
            pubs = [Client(port=ports["tcp"], clientid=f"xpub{p}")
                    for p in range(n_pub)]
            for cl in (gwin, lwctl, lwup, *pubs):
                await cl.connect()
                clients.append(cl)
            await gwin.subscribe("gw/in/#", qos=1)
            await lwup.subscribe(f"lwm2m/{EXT_EP}/up/#", qos=0)
            lwdev, lwloc = await _lwm2m_register(node, gw["lwm2m"].port)
            subs, ids, nums, n_shared, n_entries = \
                await _subscribe_population(ports["tcp"], n_filters, n_sub)
            clients += subs
            a = {"filters": ids * nums, "shared_filters": n_shared,
                 "subscriptions": n_entries, "publishers": n_pub,
                 "setup_s": time.time() - t0}
            log(f"phase 20a: booted and subscribed in {a['setup_s']:.1f} s")
            t0 = time.time()
            await _warm_up(node, pubs[0], subs, nums)
            a["warm_up_s"] = time.time() - t0
            a["governor_wait_s"] = await _below_overload(node)
            seed = SEED + 22
            per_pub = total // n_pub
            want, shared = _ext_want(seed, n_pub, per_pub, ids, nums, dests)
            hooked_want = sum(
                i in EXT_HOOK_IDS for p in range(n_pub)
                for i, _n in flood_pairs(seed, p, per_pub, ids, nums))
            for cl in (*stomps, *sns, *coaps):
                cl.got.clear()
            # the StatsD baseline: loaded here, so this first flush (its
            # interval loop has not run yet) sends every counter's whole
            # value, each later flush its delta
            statsd = StatsdApp(node, {
                "host": "127.0.0.1", "port": ssock.getsockname()[1],
                "interval": EXT_STATSD_S}).load()
            apps_up.append(statsd)
            statsd.flush()
            v0 = m.val("messages.publish")
            hooked0 = provider.publishes if provider else 0
            scrapes = []

            async def scraper():
                """EXT_SCRAPES scrapes of /metrics while the flood runs,
                at a quarter, half and three quarters of its PUBLISHes."""
                for q in range(1, EXT_SCRAPES + 1):
                    mark = v0 + q * total // (EXT_SCRAPES + 1)
                    while m.val("messages.publish") < mark:
                        await asyncio.sleep(0.01)
                    st, text = await _http(srv.port, "GET", "/metrics",
                                           bearer=tok)
                    if st != 200:
                        raise AssertionError(f"phase 20d: /metrics {st}")
                    scrapes.append(_exposition_check(text.decode()))
            scrape_task = asyncio.get_running_loop().create_task(scraper())
            gc.collect()
            gc.freeze()
            dm0 = m.val("routing.device.messages")
            pb = node.publish_batcher
            chooser = pb._device_worth_it
            pb._device_worth_it = lambda: True
            diag = ("routing.device.cold_class",
                    "routing.device.cold_compact_class",
                    "routing.device.eager_windows",
                    "routing.device.bypassed", "routing.device.batches",
                    "routing.host.messages", "routing.device.host_delta",
                    "routing.device.supervised_bypass",
                    "pipeline.deliver.rows", "messages.routed.device")
            g0 = {k: m.val(k) for k in diag}
            try:
                f = await _boot_flood(node, subs, pubs, ids, nums, total,
                                      seed, where="phase 20a")
            finally:
                pb._device_worth_it = chooser
            f.pop("got")
            a["routing"] = {k: m.val(k) - v for k, v in g0.items()}
            a["chooser_us"] = {"device": f["dev_msg_us"],
                               "host": f["host_msg_us"]}
            # the flood's device share by messages: the gateway
            # subscribers' copies make its delivered-row share pass 1
            a["device_msg_share"] = \
                (m.val("routing.device.messages") - dm0) / f["sent"]
            if a["device_msg_share"] < E2E_MIN_DEVICE_SHARE:
                raise AssertionError(f"phase 20a: {a['device_msg_share']} "
                                     f"of the flood's messages routed by "
                                     f"the device engine")
            await asyncio.wait_for(scrape_task, EXT_TIMEOUT_S)
            a["flood"] = f
            # every gateway subscriber's known answer, UDP included
            gws_all = stomps + sns + coaps
            deadline = time.perf_counter() + EXT_TIMEOUT_S
            while time.perf_counter() < deadline and any(
                    len(c.got) < len(want[c.name]) for c in gws_all):
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.2)
            a["gateway_clients"] = {c.name: (len(c.got), len(want[c.name]))
                                    for c in gws_all}
            bad = {c.name for c in gws_all
                   if collections.Counter(c.got)
                   != collections.Counter(want[c.name])}
            # order: a STOMP connection reads each publisher's messages
            # of a delivery class in publish order (TCP); the UDP clients
            # are held to counts
            def by_class(rows):
                out = collections.defaultdict(list)
                for p, k in rows:
                    out[(p, shared[(p, k)])].append(k)
                return out
            a["stomp_in_order"] = all(
                by_class(c.got) == by_class(want[c.name]) for c in stomps)
            if bad or not a["stomp_in_order"]:
                raise AssertionError(f"phase 20a: gateway clients "
                                     f"{a['gateway_clients']}; wrong "
                                     f"{sorted(bad)}; STOMP order "
                                     f"{a['stomp_in_order']}")
            a["window_err"] = e2e_window_check(node, ids, nums, SEED + 23,
                                               *window)
            a["supervise"] = check_supervised(node, "phase 20a")
            # 20d's flood numbers: scrapes, the counter after it, StatsD
            # (unload stops the interval loop and flushes the last deltas)
            statsd.unload()
            apps_up.remove(statsd)
            v1 = m.val("messages.publish")
            d = {"scrapes": scrapes}
            for _ in range(5):
                before = m.val("messages.publish")
                st, text = await _http(srv.port, "GET", "/metrics",
                                       bearer=tok)
                after_scrape = _exposition_check(text.decode())
                if before == m.val("messages.publish"):
                    break
            d["after"] = (after_scrape["messages_publish"], before)
            if after_scrape["messages_publish"] != before:
                raise AssertionError(f"phase 20d: emqx_messages_publish "
                                     f"{d['after']}")
            if [s["messages_publish"] for s in scrapes] != sorted(
                    s["messages_publish"] for s in scrapes) or len(
                    scrapes) != EXT_SCRAPES:
                raise AssertionError(f"phase 20d: scrapes {scrapes}")
            await asyncio.sleep(0.2)
            pubs_lines = [int(x.split(":")[1].split("|")[0])
                          for dgram in statsd_got
                          for x in dgram.split("\n")
                          if x.startswith("emqx.messages.publish:")]
            d["statsd"] = {"datagrams": len(statsd_got),
                           "first": pubs_lines[:1], "v0": v0,
                           "deltas": sum(pubs_lines[1:]), "want": v1 - v0,
                           "flushes_with_publish": len(pubs_lines)}
            if pubs_lines[:1] != [v0] or sum(pubs_lines[1:]) != v1 - v0:
                raise AssertionError(f"phase 20d: StatsD {d['statsd']}")
            a["exhook_publishes"] = (provider.publishes - hooked0
                                     if provider else None)
            a["exhook_want"] = hooked_want
            if provider and a["exhook_publishes"] != hooked_want:
                raise AssertionError(f"phase 20e: {a['exhook_publishes']} "
                                     f"OnMessagePublish calls for "
                                     f"{hooked_want} PUBLISHes to its "
                                     f"topics")
            out["a"] = a
            # 20b: gateway ingress
            out["b"] = await _ext_ingress(node, stomps[0], snpub, copub, gwin)
            # 20c: LwM2M
            out["c"] = await _ext_lwm2m(node, lwdev, lwloc, lwctl, lwup)
            # 20d: telemetry and the plugin
            await _until(lambda: reports, EXT_TIMEOUT_S)
            d["telemetry"] = {"reports": len(reports),
                              "emqx_version": reports[0]["emqx_version"],
                              "active_plugins": reports[0]["active_plugins"],
                              "num_clients": reports[0]["num_clients"]}
            if len(reports) != 1 or reports[0]["emqx_version"] \
                    != __version__ or reports[0]["uuid"] != tele.uuid:
                raise AssertionError(f"phase 20d: telemetry {reports}")
            cli = Cli(node)
            plugin_mod = sys.modules[EXT_PLUGIN]
            d["plugins"] = {"loaded": loaded,
                            "list": await cli.run(["plugins", "list"])}
            plugins.unload("phase20")
            d["plugins"]["after_unload"] = await cli.run(["plugins",
                                                          "list"])
            d["plugins"]["events"] = list(plugin_mod.EVENTS)
            want_ev = [("load", node.name, {"k": 20}), ("unload", {"k": 20})]
            if loaded != 1 or d["plugins"]["list"] != \
                    "Plugin(phase20, enabled=True)" or \
                    d["plugins"]["after_unload"] != \
                    "Plugin(phase20, enabled=False)" or \
                    d["plugins"]["events"] != want_ev:
                raise AssertionError(f"phase 20d: plugins {d['plugins']}")
            out["d"] = d
            # the end: every gateway socket closes with the listeners
            for cl in stomps:
                await cl.close()
            for cl in (*sns, *coaps, *extra):
                cl.transport.close()
            if node.exhook is not None:
                out["e"] = {"calls": dict(provider.calls)}
                await node.exhook.unload()
            for app in apps_up:
                app.unload()
            apps_up.clear()
            await _boot_stop(node, clients)
            stopped = True
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     gw["stomp"].port)
                w.close()
                stomp_open = True
            except OSError:
                stomp_open = False
            out["end"] = {
                "registry": node.gateway_registry.list(),
                "stomp_accepts": stomp_open,
                "udp_closed": all(gw[n].transport.is_closing()
                                  for n in ("mqttsn", "coap", "lwm2m"))}
            if out["end"] != {"registry": [], "stomp_accepts": False,
                              "udp_closed": True}:
                raise AssertionError(f"phase 20: after stop_listeners "
                                     f"{out['end']}")
            out["counters"] = {k: m.val(k) for k in (
                "messages.publish", "messages.delivered",
                "messages.routed.device", "routing.host.messages",
                "client.connected", "client.disconnected")}
        finally:
            gc.unfreeze()
            for app in apps_up:
                app.unload()
            if not stopped:
                await _boot_stop(node, clients)
            st_transport.close()
            await tsrv.stop()
            sys.path.remove(tmp)
            sys.modules.pop(EXT_PLUGIN, None)
        return out

    try:
        return asyncio.run(run())
    finally:
        for s in (provider, handler):
            if s is not None:
                s.server.stop(grace=0.2)
        shutil.rmtree(tmp, ignore_errors=True)


def ext_phase(dev, card: str, f19a=None) -> dict:
    """Phase 20 on the card; prints its lines (19a's flood of the same
    call beside 20a's)."""
    t0 = time.time()
    r = ext_drive(dev)
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    f = a["flood"]
    log(f"phase 20a: booted etc/emqx.conf with apps {r['apps']}, gateways "
        f"{[(g['name'], g.get('listener')) for g in r['gateways']]}; "
        f"{a['filters']} filters ({a['shared_filters']} shared) subscribed "
        f"over TCP beside {EXT_STOMP} STOMP, {EXT_SN} MQTT-SN and "
        f"{EXT_COAP} CoAP subscribers, setup {a['setup_s']:.1f} s, warm-up "
        f"{a['warm_up_s']:.1f} s")
    log(f"phase 20a: {f['sent']} PUBLISHes from {a['publishers']} TCP "
        f"publishers (every 4th QoS 1): {f['per_sec']} msgs/s, every "
        f"message once and in order; client p50 {f['lat_p50_ms']:.1f} / "
        f"p99 {f['lat_p99_ms']:.1f} ms; device share "
        f"{a['device_msg_share']:.4f} of the messages over {f['windows']} "
        f"windows ({f['batches']} batches; {f['device_routed']} deliveries "
        f"routed by the device, {f['lane_rows']} rows by the delivery "
        f"lanes); {card}")
    if f19a is not None:
        log(f"phase 20a: beside phase 19a in this run: {f19a['per_sec']} "
            f"msgs/s")
    log(f"phase 20a: routing over the flood {a['routing']}; the chooser "
        f"(held on the device) estimated device "
        f"{a['chooser_us']['device']:.1f} / host "
        f"{a['chooser_us']['host']:.1f} us a message")
    log(f"phase 20a: gateway clients (received, known answer) "
        f"{a['gateway_clients']}; every STOMP connection in publish order "
        f"{a['stomp_in_order']}")
    log(f"phase 20a: launches {f['launches']}; a window: shape_match "
        f"{_shape_rates(f['fold_shapes'], f['windows'])}, prefix_sum "
        f"{_shape_rates(f['scan_shapes'], f['windows'])}; two engine "
        f"windows == plain path (max |diff| {a['window_err']})")
    log(f"phase 20b: gateway ingress {EXT_IN}: {b['received']} of "
        f"{b['want']} at the MQTT subscriber, each once {b['exactly_once']}; "
        f"STOMP {b['stomp_s']:.2f} s, MQTT-SN {b['mqttsn_s']:.2f} s "
        f"(PUBACKs {b['mqttsn_pubacks']}), CoAP {b['coap_s']:.2f} s "
        f"({b['coap_codes']}); host routes they added {b['counters']}")
    log(f"phase 20c: LwM2M {c['register']}, {c['reads']} read commands "
        f"({c['device_routed']} routed by the device), {c['replies']} "
        f"replies ok {c['replies_ok']} in {c['seconds']:.2f} s; "
        f"deregister {c['deregister']}, sessions left {c['sessions_left']}")
    log(f"phase 20d: /metrics during the flood {d['scrapes']}; after it "
        f"emqx_messages_publish {d['after'][0]} == node.metrics "
        f"{d['after'][1]}; StatsD {d['statsd']}; telemetry "
        f"{d['telemetry']}; plugins {d['plugins']['list']!r} -> "
        f"{d['plugins']['after_unload']!r}, events {d['plugins']['events']}")
    if r["grpc"]:
        log(f"phase 20e: grpc {r['grpc']}: exhook OnMessagePublish "
            f"{a['exhook_publishes']} for the {a['exhook_want']} PUBLISHes "
            f"of the flood to its topics (device/d{{j}}/# for j in "
            f"{list(EXT_HOOK_IDS)}), each answered CONTINUE in the "
            f"batcher's fold; calls {r['e']['calls']}")
    else:
        log("phase 20e: exhook: did not run (no grpc on this host)")
    log(f"phase 20: after stop_listeners {r['end']}; counters "
        f"{r['counters']}")
    r["seconds"] = time.time() - t0
    log(f"phase 20: {r['seconds']:.1f} s; {card}")
    return r




def main() -> int:
    import faulthandler

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from emqx_tpu_torch.ops.build import build
    t_all = time.time()
    arm_deadline("1-3", t_all)
    card = card_line()
    log(f"phase 1: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(card)

    dev = torch.device("cuda")
    phase_s = {}
    t_phase = [time.time()]

    def wall(name: str) -> None:
        """The wall seconds of the phase that just ended."""
        now = time.time()
        phase_s[name] = round(now - t_phase[0], 1)
        t_phase[0] = now
        log(f"phase {name}: {phase_s[name]} s wall")
    wall("1")
    t0 = time.time()
    out = build(ptxas_info=True)
    log(out.strip())
    log(f"phase 2: built shape_match.cu, prefix_sum.cu and ring_rotate.cu "
        f"in {time.time() - t0:.1f} s")
    from emqx_tpu_torch import native
    t0 = time.time()
    if not native.available():
        raise AssertionError("the host native library did not build: the "
                             "columnar ingress would run on its Python "
                             "mirrors")
    log(f"phase 2: host library {native.library_path().name} "
        f"({native.SOURCE.name}, {' '.join(native.CXX_FLAGS)}) ready in "
        f"{time.time() - t0:.1f} s")
    wall("2")

    err_scan = check_prefix_sum(dev)
    err_fold = pattern_check(dev)
    wall("3")
    arm_deadline("4", t_all)
    b = bench_engine(dev, SUBS, BATCH, WINDOW, SEED)
    torch.cuda.synchronize()
    st = b["eng"].tables.shapes
    log(f"phase 4: {b['F']} filters, {b['n_groups']} shared groups; tables "
        f"built and uploaded in {b['t_build']:.1f} s (buckets "
        f"{tuple(st.buckets.shape)}, {st.buckets.numel() * 4 / 1e6:.0f} MB)")
    tp, tl, dl, _mh = b["staged"]
    err_fold = max(err_fold, check_shape_match(
        st, tp.reshape(-1, 8), tl.reshape(-1), dl.reshape(-1),
        f"the {b['F']}-filter bench population"))

    r = drive_main_path(b, TIMED_WINDOWS)
    launches = r["launches"]
    log(f"phase 4: RouteEngine.route() of {WINDOW * BATCH} topic strings in "
        f"{r['t_route']:.2f} s incl. host encode and decode; every plan "
        f"equals the known answer; launches {launches}")
    if launches["shape_match"] == 0 or launches["prefix_sum"] == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    log("phase 4: window planes, CSR payload and cursors == plain path "
        "(exact)")
    log(f"phase 4: {TIMED_WINDOWS} timed windows of {WINDOW} x {BATCH} "
        f"topics, every message checked, cursors threaded; window latency "
        f"(device window + CSR readback) p50 {r['p50']:.3f} ms, p99 "
        f"{r['p99']:.3f} ms, max {r['lat_ms'].max():.3f} ms; "
        f"{r['mps']:.0f} topic-matches/s")

    eng, staged = b["eng"], b["staged"]
    profile_window("profile", lambda: eng.route_encoded(*staged), r["p50"])
    del eng, staged
    sm, ps = time_kernels(b, r["n_entries"])
    err_scan = max(err_scan, ps["err"])
    log(f"kernel shape_match [{WINDOW * BATCH}, 8]: {sm['ms']:.4f} ms "
        f"(bound {sm['bound_ms']:.4f} ms by {sm['bound_by']}: "
        f"{sm['bytes'] / 1e6:.1f} MB, {sm['rows']} bucket rows), plain "
        f"{sm['plain_ms']:.4f} ms, library none")
    log(f"kernel prefix_sum {tuple(r['n_entries'].shape)}: {ps['ms']:.4f} ms "
        f"(bound {ps['bound_ms']:.4f} ms by {ps['bound_by']}), plain "
        f"{ps['plain_ms']:.4f} ms, torch.cumsum {ps['library_ms']:.4f} ms; "
        f"{ps['call_ms']:.4f} ms per wrapper call back to back")
    scan_shapes = time_scan_shapes(dev, r["shapes"], "shape-hash")
    summary = {
        "subs": b["F"], "batch": BATCH, "window": WINDOW,
        "timed_windows": TIMED_WINDOWS, "topic_matches_per_s": r["mps"],
        "window_p50_ms": r["p50"], "window_p99_ms": r["p99"],
        "window_max_ms": float(r["lat_ms"].max()),
        "route_call_s": r["t_route"], "card": card, "phase_s": phase_s}
    del b, r
    torch.cuda.empty_cache()
    wall("4")
    arm_deadline("6-7", t_all)
    ring, mesh, mesh_scan_shapes = mesh_phase(dev)
    torch.cuda.empty_cache()
    wall("6-7")
    arm_deadline("8", t_all)
    e2e = e2e_phase(dev, card)
    torch.cuda.empty_cache()
    wall("8")
    arm_deadline("9", t_all)
    layers = layers_phase(dev, card)
    torch.cuda.empty_cache()
    wall("9")
    arm_deadline("10", t_all)
    cover = cover_phase(dev, card)
    wall("10")
    arm_deadline("11", t_all)
    # phase 12's two processes load while phase 11 runs
    kids12 = [_Child("--overload"), _Child("--overload")]
    ingress = ingress_phase(card)
    wall("11")
    arm_deadline("12", t_all)
    overload = overload_phase(card, kids12)
    wall("12")
    arm_deadline("13", t_all)
    chaos = chaos_phase(card, e2e["chaos"]["probe_launches"])
    wall("13")
    arm_deadline("14", t_all)
    mesh_node = mesh_node_phase(dev, card)
    torch.cuda.empty_cache()
    wall("14")
    arm_deadline("15", t_all)
    boot = boot_phase(dev, card)
    torch.cuda.empty_cache()
    wall("15")
    arm_deadline("16", t_all)
    apps = apps_phase(dev, card, boot["a"]["flood"]["batch_form"])
    torch.cuda.empty_cache()
    wall("16")
    arm_deadline("17", t_all)
    cluster = cluster_phase(dev, card)
    torch.cuda.empty_cache()
    wall("17")
    arm_deadline("18", t_all)
    secure = secure_phase(dev, card, boot["a"]["flood"], apps["a"]["flood"])
    wall("18")
    arm_deadline("19", t_all)
    db = db_phase(dev, card, secure["a"]["flood"])
    torch.cuda.empty_cache()
    wall("19")
    arm_deadline("20", t_all)
    kid5 = _Child("--scan-shapes")    # loads while phase 20 runs
    ext = ext_phase(dev, card, db["a"]["flood"])
    torch.cuda.empty_cache()
    wall("20")
    arm_deadline("5", t_all)
    timed = {tuple(d["shape"]) for d in scan_shapes + mesh_scan_shapes}
    groups = []           # (where, {shape: launches a window}), new shapes
    for cell, n in (("skew", "windows"), ("churn", "batches")):
        c = layers[cell]
        new = {shape: cnt / c[n] for shape, cnt in c["scan_shapes"].items()
               if shape not in timed}
        timed |= set(new)
        groups.append((f"layers {cell}", new))
    for n, c in cover.items():
        new = {shape: cnt for shape, cnt in c["A"]["scan_shapes"].items()
               if shape not in timed}
        timed |= set(new)
        groups.append((f"cover {n} A", new))
    for where, runs, n in (("ingress", ingress, "device_windows"),
                           ("overload", overload, None)):
        new = {}
        for r in runs.values():      # launches a window, the most of a run
            wins = r[n] if n else r["windows"]["device"]
            for shape, cnt in r["scan_shapes"]:
                if tuple(shape) not in timed:
                    new[tuple(shape)] = max(new.get(tuple(shape), 0),
                                            cnt / max(1, wins))
        timed |= set(new)
        groups.append((where, new))
    # phase 14b: the mesh node's window shapes, launches a window
    wins = max(1, mesh_node["b"]["flood"]["batches"])
    new = {tuple(shape): cnt / wins
           for shape, cnt in mesh_node["b"]["scan_shapes"].items()
           if tuple(shape) not in timed}
    timed |= set(new)
    groups.append(("mesh node", new))
    # phases 15, 16, 18, 19 and 20: the booted nodes' and the dense node's
    # window shapes
    new = {}
    for f in (boot["a"]["flood"], boot["c"]["csr"], boot["c"]["dense"],
              apps["a"]["flood"], apps["b"], secure["a"]["flood"],
              db["a"]["flood"], ext["a"]["flood"]):
        for shape, cnt in f["scan_shapes"].items():
            if tuple(shape) not in timed:
                new[tuple(shape)] = max(new.get(tuple(shape), 0),
                                        cnt / max(1, f["windows"]))
    timed |= set(new)
    groups.append(("boot", new))
    layer_scan_shapes = time_scan_shapes_apart(groups, kid5)
    layers_err = max(layers["churn"]["hold_skew_err"],
                     layers["churn"]["hold_err"],
                     *(c["hold_err"] for c in cover.values()),
                     *(r["hold_err"] for r in ingress.values()),
                     *(r["hold_err"] for r in overload.values()))
    for name in ("shape_match", "prefix_sum"):
        if sum(c["A"]["launches"][name] for c in cover.values()) == 0:
            raise AssertionError(f"phase 10: {name} was not launched on "
                                 f"the covered path")
    wall("5 (kernel 2's timed shapes)")
    peak = max(_RUN_PEAK[0], torch.cuda.max_memory_allocated())
    log(f"peak device memory {peak / 1e9:.2f} "
        f"GB; whole run {time.time() - t_all:.1f} s; wall seconds by phase "
        f"{json.dumps(phase_s)}")

    def by_path(name):
        """The kernel's launches on every path this script drives, each
        counted from 0 just before the path ran."""
        out = {"shape-hash route()": launches[name],
               "mesh route()": mesh["launches"][name]}
        for label, f in e2e["floods"].items():
            out[f"e2e flood {label}"] = f["launches"][name]
        out["layers skew A (timed pass)"] = \
            layers["skew"]["A"]["launches"][name]
        out["layers churn A (timed pass)"] = \
            layers["churn"]["A"]["launches"][name]
        # phase 10: node A's (covering on) timed passes, both populations
        out["cover"] = sum(c["A"]["launches"][name] for c in cover.values())
        for label, r in ingress.items():
            out[f"ingress {label}"] = r["launches"][name]
        for label, r in overload.items():
            out[f"overload governor {label}"] = r["launches"][name]
        out["chaos matrix"] = chaos["matrix"]["launches"].get(name, 0)
        out["supervise probes"] = chaos["probes"].get(name, 0)
        # phase 14: the mesh node's flood (14b), tools/sharded_bench.py's
        # pipelined batches on it (14a) and the faulted flood (14c)
        out["mesh-node"] = mesh_node["b"]["flood"]["launches"][name]
        out["mesh-node sharded drive"] = mesh_node["a"]["launches"][name]
        out["mesh-node fault flood"] = \
            mesh_node["b"]["fault"]["launches"][name]
        # phase 15: the booted node (15a), the CSR and dense floods and
        # the mesh twins (15c), the host-only node (15d: none)
        out["boot 15a"] = boot["a"]["flood"]["launches"][name]
        for mode in ("csr", "dense"):
            out[f"boot 15c {mode}"] = boot["c"][mode]["launches"][name]
            out[f"boot 15c mesh {mode}"] = \
                boot["c"]["mesh"][mode]["launches"][name]
        out["boot 15d host-only"] = boot["d"]["launches"][name]
        # phase 16: the apps-on flood (16a) and the retained stream (16b)
        out["apps 16a"] = apps["a"]["flood"]["launches"][name]
        out["apps 16b"] = apps["b"]["launches"][name]
        # phase 17: each node's flood dispatches (17a), the restored
        # node's flood (17c, its first window apart), the clustered mesh
        # node's windows and the windows after it left (17d)
        for p in cluster["a"]["nodes"]:
            out[f"cluster 17a {p['name']}"] = p["launches"][name]
        out["cluster 17c first window"] = \
            cluster["c"]["first_window_launches"].get(name, 0)
        out["cluster 17d clustered"] = cluster["d"]["launches"][name]
        out["cluster 17d standalone"] = \
            cluster["d"]["standalone"]["launches"][name]
        # phase 18: the secured node's flood (18a)
        out["secure 18a"] = secure["a"]["flood"]["launches"][name]
        # phase 19: the database-backed node's flood (19a) and the
        # bridge's forwards (19b)
        out["db 19a"] = db["a"]["flood"]["launches"][name]
        out["db 19b"] = db["b"]["launches"][name]
        # phase 20: the flood to the gateway subscribers (20a)
        out["ext 20a"] = ext["a"]["flood"]["launches"][name]
        return out

    def per_window(name):
        """Phases 15-20's launches a window: 15a and 15c's floods and
        mesh drives, 16a's flood and 16b's retained stream, each 17a
        node's dispatches, 17d's clustered mesh windows, 18a's, 19a's and
        20a's floods."""
        out = {"boot 15a": boot["a"]["flood"]}
        for mode in ("csr", "dense"):
            out[f"boot 15c {mode}"] = boot["c"][mode]
            out[f"boot 15c mesh {mode}"] = boot["c"]["mesh"][mode]
        out["apps 16a"] = apps["a"]["flood"]
        out["apps 16b"] = apps["b"]
        out["secure 18a"] = secure["a"]["flood"]
        out["db 19a"] = db["a"]["flood"]
        out["ext 20a"] = ext["a"]["flood"]
        per = {k: round(f["launches"][name] / max(1, f["windows"]), 3)
               for k, f in out.items()}
        for p in cluster["a"]["nodes"]:
            per[f"cluster 17a {p['name']}"] = \
                round(p["launches_per_window"][name], 3)
        d = cluster["d"]
        per["cluster 17d clustered"] = round(
            d["launches"][name] / max(1, d["windows"]), 3)
        return per

    kernels = [
        {"name": "shape_match", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/shape_match.cu",
         "replaces": "emqx_tpu/ops/pallas_fold.py:121",
         "launches": launches["shape_match"],
         "launches_by_path": by_path("shape_match"),
         "launches_per_window_boot": per_window("shape_match"),
         "max_abs_err": max(err_fold, e2e["window_err"], layers_err,
                            e2e["chaos"]["held_err"],
                            secure["a"]["window_err"],
                            db["a"]["window_err"], ext["a"]["window_err"]),
         **{k: sm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}},
        {"name": "prefix_sum", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/prefix_sum.cu",
         "replaces": "emqx_tpu/ops/pallas_scan.py:79",
         "launches": launches["prefix_sum"],
         "launches_by_path": by_path("prefix_sum"),
         "launches_per_window_boot": per_window("prefix_sum"),
         "max_abs_err": max(err_scan, e2e["window_err"], layers_err,
                            e2e["chaos"]["held_err"], mesh_node["err"],
                            secure["a"]["window_err"],
                            db["a"]["window_err"], ext["a"]["window_err"]),
         **{k: ps[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
         "shapes": scan_shapes + mesh_scan_shapes + layer_scan_shapes},
        dict(ring, launches_by_path=by_path("ring_rotate"),
             launches_per_window_boot=per_window("ring_rotate"),
             max_abs_err=max(ring["max_abs_err"], mesh_node["err"])),
    ]
    e2e_out = {k: v for k, v in e2e.items() if k != "floods"}
    e2e_out["floods"] = {d: {k: v for k, v in f.items() if k != "got"}
                         for d, f in e2e["floods"].items()}
    layers_out = {k: v for k, v in layers.items() if k != "stats"}
    for cell in ("skew", "churn"):
        layers_out[cell] = {k: v for k, v in layers[cell].items()
                            if k != "scan_shapes"}
    cover_out = {n: {k: v for k, v in c.items() if k != "stats_A"}
                 for n, c in cover.items()}
    for c in cover_out.values():
        c["A"] = {k: v for k, v in c["A"].items() if k != "scan_shapes"}
    ingress_out = {k: {f: v for f, v in r.items() if f != "stages"}
                   for k, r in ingress.items()}
    log(json.dumps({"summary": summary, "mesh": mesh, "e2e": e2e_out,
                    "layers": layers_out, "cover": cover_out,
                    "ingress": ingress_out, "overload": overload,
                    "chaos": chaos,
                    "mesh_node": {k: v for k, v in mesh_node["b"].items()
                                  if k != "scan_shapes"},
                    "mesh_sharded": mesh_node["a"],
                    "capture": mesh_node["capture"],
                    "boot": _boot_out(boot), "apps": _boot_out(apps),
                    "cluster": _boot_out(cluster),
                    "secure": _boot_out(secure), "db": _boot_out(db),
                    "ext": _boot_out(ext)}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


def _boot_out(boot: dict) -> dict:
    """Phase 15's results for the JSON line: the shape dicts keyed by
    strings."""
    def fix(x):
        if isinstance(x, dict):
            return {str(list(k)) if isinstance(k, tuple) else k: fix(v)
                    for k, v in x.items()}
        return x
    return fix(boot)




def child_main(flag: str) -> int:
    """``--ingress``, ``--overload``, ``--scan-shapes``: one phase-11
    configuration, one phase-12 twin, or kernel 2 at the groups' shapes
    (phase 5's, or phase 7's) on a card; its JSON line last. The JSON
    argument follows the flag, or, where it does not, comes on stdin once
    the child is loaded (``_Child``); end-of-file there ends it unrun."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3:
        arg = sys.argv[2]
    else:
        _child_ready()
        arg = sys.stdin.readline()
        if not arg:
            return 0
    a = json.loads(arg)
    arm_deadline({"--ingress": "11", "--overload": "12",
                  "--scan-shapes": "5"}[flag], time.time(), say=False)
    if flag == "--ingress":
        out = ingress_one("cuda", a["conns"], a["columnar"])
    elif flag == "--overload":
        out = overload_one("cuda", a["governor"], a["rate"])
    else:
        out = []
        for g in a["groups"]:
            shapes = {tuple(k): v for k, v in g["shapes"]}
            out += time_scan_shapes(torch.device("cuda"), shapes,
                                    g["where"])
    print(json.dumps(out), flush=True)
    return 0


def phase_main(flag: str) -> int:
    """``--boot``, ``--apps``, ``--cluster``, ``--secure``, ``--db``,
    ``--ext``: build the kernels and run phase 15, 16, 17, 18, 19 or 20
    alone on a card under that phase's deadline, then print its results
    as one JSON line."""
    import faulthandler

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from emqx_tpu_torch import native
    from emqx_tpu_torch.ops.build import build
    phase, run, key = {"--boot": ("15", boot_phase, "boot"),
                       "--apps": ("16", apps_phase, "apps"),
                       "--cluster": ("17", cluster_phase, "cluster"),
                       "--secure": ("18", secure_phase, "secure"),
                       "--db": ("19", db_phase, "db"),
                       "--ext": ("20", ext_phase, "ext")}[flag]
    t0 = time.time()
    card = card_line()
    log(build().strip())
    if not native.available():
        raise AssertionError("the host native library did not build")
    arm_deadline(phase, t0)
    r = run(torch.device("cuda"), card)
    log(json.dumps({key: _boot_out(r)}))
    log(card)
    faulthandler.cancel_dump_traceback_later()
    return 0




if __name__ == "__main__":
    if len(sys.argv) in (2, 3) and sys.argv[1] in (
            "--scan-shapes", "--ingress", "--overload"):
        sys.exit(child_main(sys.argv[1]))
    if len(sys.argv) == 2 and sys.argv[1] == "--trace-cost":
        sys.exit(trace_cost_main())
    if len(sys.argv) == 2 and sys.argv[1] == "--warm-stress":
        sys.exit(warm_stress_main())
    if len(sys.argv) == 2 and sys.argv[1] in (
            "--boot", "--apps", "--cluster", "--secure", "--db", "--ext"):
        sys.exit(phase_main(sys.argv[1]))
    sys.exit(main())
