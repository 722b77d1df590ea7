"""Port vs JAX reference: the HOCON loader and the config-file boot.

The same documents go through ``emqx_tpu.utils.hocon`` and the port's
copy: the reference's own test inputs (``tests/test_hocon_config.py``),
the repo's ``etc/emqx.conf``, and a few hundred documents made from a
seed — valid ones (random trees written in every syntax the loader takes)
and malformed ones (the valid ones with characters dropped, doubled or
replaced). Each must load to equal dicts or fail with the same exception
type and message; ``dumps`` must render equal text that loads back to the
same tree. Then ``Config.load_file`` with its override file, ``update``
through handlers (one vetoes), persistence across reloads, and the schema
check on boot, through both packages.
"""

import os

import numpy as np
import pytest

from emqx_tpu.broker import config as jconfig
from emqx_tpu.utils import hocon as jhocon
from emqx_tpu_torch.broker import config as tconfig
from emqx_tpu_torch.utils import hocon as thocon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 12
N_DOCS = 300


def outcome(fn, *args):
    """(result) or (exception type name, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared, not handled
        return ("raise", type(e).__name__, str(e))


def same(fn_name: str, *args):
    j = outcome(getattr(jhocon, fn_name), *args)
    t = outcome(getattr(thocon, fn_name), *args)
    assert t == j, (args, j, t)
    return t


REFERENCE_DOCS = [
    """
    # comment
    broker {
      sys_msg_interval = 30        // trailing comment
      shared_subscription_strategy = random
    }
    mqtt.max_inflight = 64
    mqtt.retain_available = false
    listeners.default { type: tcp, port: 1883 }
    tags = [a, "b c", 3]
    nothing = null
    """,
    """
    a { x = 1 }
    a { y = 2 }
    a.x = 3
    arr = [1]
    arr += 2
    fresh += "first"
    """,
    """
    base { port = 1883 }
    l1.port = ${base.port}
    l2.port = ${?EMQX_TORCH_TEST_PORT}
    l3 { port = ${?MISSING_THING_FOR_TORCH} }
    """,
    "x = ${no.such.path}",
    r'''
    a = "line\nbreak"
    b = """raw "quoted" text"""
    "key with space" = ok
    ''',
    "unterminated { a = 1",
    'a = "open',
    "a = [1, 2",
    "}",
    "a = 1\nb += 2\nb += 3\nc = [x, ${a}]",
    "k += 1\nk = 2\nk += 3",
    "a = 5\na += 6",
    "v = ${?NOPE_TORCH}\nw = [1, ${?NOPE_TORCH}, 2]",
]


@pytest.mark.parametrize("k", range(len(REFERENCE_DOCS)))
def test_reference_inputs(k, monkeypatch):
    monkeypatch.setenv("EMQX_TORCH_TEST_PORT", "2883")
    same("loads", REFERENCE_DOCS[k])


def test_include_and_load(tmp_path):
    (tmp_path / "base.conf").write_text('mqtt { max_inflight = 7 }\n')
    (tmp_path / "main.conf").write_text(
        'include "base.conf"\nmqtt.idle_timeout = 30\n')
    (tmp_path / "bad.conf").write_text('include base.conf\n')
    (tmp_path / "missing.conf").write_text('include "nope.conf"\n')
    got = same("load", str(tmp_path / "main.conf"))
    assert got[1]["mqtt"] == {"max_inflight": 7, "idle_timeout": 30}
    same("load", str(tmp_path / "bad.conf"))
    j = outcome(jhocon.load, str(tmp_path / "missing.conf"))
    t = outcome(thocon.load, str(tmp_path / "missing.conf"))
    assert j[:2] == t[:2] == ("raise", "FileNotFoundError")


def test_shipped_config():
    """etc/emqx.conf loads to the same tree, and renders the same."""
    got = same("load", os.path.join(REPO, "etc", "emqx.conf"))
    assert got[0] == "ok" and "listeners" in got[1]
    assert thocon.dumps(got[1]) == jhocon.dumps(got[1])
    assert thocon.loads(thocon.dumps(got[1])) == got[1]


@pytest.mark.parametrize("s", ["30s", "100ms", "2h", "1d", "1w", "1.5m",
                               "plain", "", " 7s ", "16KB", "1MB", "2gb",
                               "10b", "1.5kb", "12", "3x"])
def test_durations_sizes(s):
    assert thocon.parse_duration(s) == jhocon.parse_duration(s)
    assert thocon.parse_size(s) == jhocon.parse_size(s)


# ---- seeded documents ----------------------------------------------------

WORDS = ["a", "b", "node", "port", "max_inflight", "k-1", "x_y", "key two",
         "zone", "0", "true", "on"]
SCALARS = [0, 1, -3, 2.5, True, False, None, "tcp", "0.0.0.0", "10s", "1MB",
           "on", "0", "x y", 'q"uote', "back\\slash", "", "#hash", "a,b"]


def rand_tree(r, depth: int = 0) -> dict:
    out = {}
    for _ in range(r.randint(1, 5)):
        k = WORDS[r.randint(len(WORDS))]
        roll = r.rand()
        if roll < 0.3 and depth < 3:
            out[k] = rand_tree(r, depth + 1)
        elif roll < 0.45:
            out[k] = [SCALARS[r.randint(len(SCALARS))]
                      for _ in range(r.randint(0, 4))]
        else:
            out[k] = SCALARS[r.randint(len(SCALARS))]
    return out


def _key(k: str) -> str:
    return k if k.replace("_", "").replace("-", "").isalnum() \
        else '"' + k + '"'


def _val(v) -> str:
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, list):
        return "[" + ", ".join(_val(x) for x in v) + "]"
    return str(v)


def write_variant(r, tree: dict, prefix: str = "") -> str:
    """One rendering of `tree` in a random mix of the loader's syntax:
    `=` or `:`, dotted paths or nested blocks, commas or newlines,
    comments, `+=` appends, substitutions back to earlier scalars."""
    lines = []
    for k, v in tree.items():
        key = _key(k)
        path = prefix + key if "." not in key and '"' not in key \
            and prefix else None
        sep = [" = ", ": ", "="][r.randint(3)]
        if isinstance(v, dict):
            if path is not None and r.rand() < 0.5:
                lines.append(write_variant(r, v, path + "."))
            else:
                body = write_variant(r, v)
                lines.append(f"{key} {{\n{body}\n}}")
        elif isinstance(v, list) and v and r.rand() < 0.3:
            lines.append(f"{key}{sep}[{_val(v[0])}]")
            for x in v[1:]:
                lines.append(f"{key} += {_val(x)}")
        else:
            lines.append(f"{key}{sep}{_val(v)}")
        if r.rand() < 0.2:
            lines.append(["# note", "// note", ""][r.randint(3)])
        if r.rand() < 0.1 and path is not None \
                and not isinstance(v, (dict, list)):
            lines.append(f"sub_{r.randint(99)} = ${{{path}}}")
        if r.rand() < 0.05:
            lines.append(f"opt_{r.randint(99)} = ${{?NO_SUCH_TORCH_VAR}}")
    joiner = [",\n", "\n", ", "][r.randint(3)]
    return joiner.join(lines)


def mutate(r, text: str) -> str:
    chars = list(text)
    for _ in range(r.randint(1, 4)):
        if not chars:
            break
        i = r.randint(len(chars))
        op = r.randint(3)
        if op == 0:
            del chars[i]
        elif op == 1:
            chars.insert(i, chars[i])
        else:
            pool = "{}[]\"=:,$+#\n\\ "
            chars[i] = pool[r.randint(len(pool))]
    return "".join(chars)


def test_seeded_documents_equal_reference():
    """N_DOCS random trees: dumps of each (equal text, loading back to
    the tree), a random-syntax rendering, and a mutated copy of it: equal
    outcomes in both packages."""
    r = np.random.RandomState(SEED)
    kinds = {"ok": 0, "raise": 0}
    for _ in range(N_DOCS):
        tree = rand_tree(r)
        text = jhocon.dumps(tree)
        assert thocon.dumps(tree) == text
        assert same("loads", text) == ("ok", tree)
        doc = write_variant(r, tree)
        kinds[same("loads", doc)[0]] += 1
        for _ in range(2):
            kinds[same("loads", mutate(r, doc))[0]] += 1
    # the seed gives both kinds in numbers
    assert kinds["ok"] > N_DOCS and kinds["raise"] > N_DOCS // 10, kinds


# ---- Config.load_file, update, override persistence, schema --------------

def both_configs(path: str, override=None):
    out = []
    for mod in (jconfig, tconfig):
        out.append(outcome(mod.Config.load_file, path, override))
    return out


def test_load_update_persist(tmp_path):
    """The reference's file-boot cases through both packages: defaults
    underneath, coercion, a handler seeing the update, persistence across
    reloads, earlier overrides kept by a later update."""
    main = tmp_path / "emqx.conf"
    main.write_text("""
    mqtt { max_inflight = 12, idle_timeout = 20s }
    broker.sys_msg_interval = 45
    """)
    rows = []
    for mod in (jconfig, tconfig):
        ov = tmp_path / f"override_{mod.__name__.split('.')[0]}.conf"
        conf = mod.Config.load_file(str(main), str(ov))
        row = [conf.get("mqtt", "max_inflight"),
               conf.get("mqtt", "idle_timeout"),
               conf.get("broker", "sys_msg_interval"),
               conf.get("mqtt", "max_qos_allowed")]
        seen = []
        conf.register_handler(("mqtt",),
                              lambda p, v, c: seen.append((p, v)))
        conf.update(("mqtt", "max_inflight"), 99)
        conf.update(["broker", "sys_heartbeat_interval"], 7)
        row += [seen, conf.get("mqtt", "max_inflight"), ov.read_text()]
        again = mod.Config.load_file(str(main), str(ov))
        again.update(("mqtt", "retry_interval"), 3)
        third = mod.Config.load_file(str(main), str(ov))
        row += [third.get("mqtt", "max_inflight"),
                third.get("broker", "sys_heartbeat_interval"),
                third.get("mqtt", "retry_interval"), ov.read_text()]
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[1][:4] == [12, 20, 45, 2]


def test_default_override_file_beside_the_config(tmp_path):
    """Without an override path, emqx_override.conf beside the file wins
    on load, and update writes it."""
    main = tmp_path / "emqx.conf"
    main.write_text("mqtt.max_inflight = 12\n")
    rows = []
    for mod in (jconfig, tconfig):
        beside = tmp_path / "emqx_override.conf"
        if beside.exists():
            beside.unlink()
        c1 = mod.Config.load_file(str(main))
        c1.update(("mqtt", "max_inflight"), 64)
        rows.append((beside.read_text(),
                     mod.Config.load_file(str(main)).get(
                         "mqtt", "max_inflight"),
                     c1.override_file == str(beside)))
    assert rows[0] == rows[1] == (rows[0][0], 64, True)


@pytest.mark.parametrize("persist", [True, False])
def test_handler_veto(tmp_path, persist):
    """A raising handler vetoes the update: nothing applied, nothing
    written, the same exception in both; a handler at a deeper path sees
    a parent update too."""
    rows = []
    for mod in (jconfig, tconfig):
        ov = tmp_path / f"ov_{mod.__name__.split('.')[0]}.conf"
        conf = mod.Config(override_file=str(ov))

        def veto(path, value, _c):
            raise ValueError(f"nope {path} {value}")
        conf.register_handler(("broker", "sys_msg_interval"), veto)
        res = outcome(conf.update, ("broker",), {"x": 1}, persist)
        res2 = outcome(conf.update, ("broker", "sys_msg_interval"), 1,
                       persist)
        conf.update(("mqtt", "max_inflight"), 5, persist)
        rows.append((res, res2, conf.get("broker", "sys_msg_interval"),
                     conf.get("mqtt", "max_inflight"),
                     ov.read_text() if ov.exists() else None))
    assert rows[0] == rows[1]
    assert rows[1][2] == 60 and rows[1][0][0] == "raise"


SCHEMA_DOCS = [
    "mqtt.max_inflight = banana\n",
    "mqtt { max_inflight = lots, retain_available = 3 }\nbroker = x\n",
    "mqtt.idle_timeout = 30s\nmqtt.max_packet_size = 1MB\n",
    "my_plugin { weird = 1 }\n",
    "alarm.validity_period = 1d\nlog.enable = yes\n",
    "conn_congestion.enable_alarm = 1\n",
    "sysmon.os.sysmem_high_watermark = high\n",
    "broker.sys_msg_interval = 1m\nbroker.sys_heartbeat_interval = 5s\n",
    "force_shutdown = [1]\n",
    "listeners.x { type = tcp, port = banana }\nzones.z = 1\n",
    "mqtt.response_information = 5\nmqtt.peer_cert_as_username = cn\n",
]


@pytest.mark.parametrize("k", range(len(SCHEMA_DOCS)))
def test_schema_check_on_boot(tmp_path, k):
    """Boot-time schema errors (and the coerced values when it passes)
    equal the reference's for the sections the port keeps."""
    main = tmp_path / "emqx.conf"
    main.write_text(SCHEMA_DOCS[k])
    j, t = both_configs(str(main), str(tmp_path / "none.conf"))
    if j[0] == "raise":
        assert t == j
        return
    assert t[0] == "ok"
    for sec in ("mqtt", "broker", "alarm", "log", "conn_congestion",
                "sysmon", "listeners", "zones"):
        want = j[1].get(sec)
        got = t[1].get(sec)
        if sec == "broker":     # the port keeps a subset of the keys
            want = {kk: want[kk] for kk in got}
        assert got == want, sec


def test_check_schema_direct():
    for doc in ({"mqtt": {"idle_timeout": "30s", "max_packet_size": "1MB"}},
                {"mqtt": {"max_inflight": "lots", "retain_available": 3},
                 "broker": "not-an-object"},
                {"my_plugin": {"weird": 1}}):
        a, b = jhocon.loads(jhocon.dumps(doc)), thocon.loads(
            thocon.dumps(doc))
        assert tconfig.check_schema(b) == jconfig.check_schema(a)
        assert a == b
