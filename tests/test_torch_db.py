"""Port vs JAX reference: the database arms.

Each scenario of the reference's ``tests/test_connectors_db.py`` runs
twice, once over the reference's classes (``emqx_tpu/connectors``,
``resources``, ``apps/authn_db.py``, ``apps/authz_db.py``, its ``Node``
and ``Client``) and once over the port's copies, each time against fresh
servers from ``tests/test_torch_fake_db.py``. Both runs must give equal
transcripts: rows, verdicts, errors (type, message, code) and the bytes
every server received, with the random inputs fixed in both packages
(SCRAM nonces and salts, Mongo request ids). Beside them: the servers of
``tests/test_torch_fake_db.py`` answer the same request bytes with the
same reply bytes as ``tests/fake_db.py``'s (seen through a recording
proxy), and the boot of the database arms from a config file in both
packages, the reference's two defects included (a ``mongodb`` arm cannot
boot; a ``redis`` authn backend builds the PostgreSQL authenticator over
the Redis resource and answers ``ignore``).
"""

import asyncio
import hashlib
import itertools
import struct
import types

import pytest
import torch

import tests.fake_db as jfake
import tests.test_torch_fake_db as tfake
from emqx_tpu import client as jclient
from emqx_tpu import connectors as jconn
from emqx_tpu.apps import authn as jauthn
from emqx_tpu.apps import authn_db as jauthn_db
from emqx_tpu.apps import authz as jauthz
from emqx_tpu.apps import authz_db as jauthz_db
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.connectors import ldap as jldap
from emqx_tpu.connectors import mongo as jmongo
from emqx_tpu.connectors import mysql as jmysql
from emqx_tpu.connectors import pgsql as jpgsql
from emqx_tpu.connectors import redis as jredis
from emqx_tpu.resources import resource as jresource
from emqx_tpu.utils import bson as jbson
from emqx_tpu.utils import passwd as jpw
from emqx_tpu.utils import scram as jscram
from emqx_tpu_torch import client as tclient
from emqx_tpu_torch import connectors as tconn
from emqx_tpu_torch.apps import authn as tauthn
from emqx_tpu_torch.apps import authn_db as tauthn_db
from emqx_tpu_torch.apps import authz as tauthz
from emqx_tpu_torch.apps import authz_db as tauthz_db
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.connectors import ldap as tldap
from emqx_tpu_torch.connectors import mongo as tmongo
from emqx_tpu_torch.connectors import mysql as tmysql
from emqx_tpu_torch.connectors import pgsql as tpgsql
from emqx_tpu_torch.connectors import redis as tredis
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.resources import resource as tresource
from emqx_tpu_torch.utils import bson as tbson
from emqx_tpu_torch.utils import scram as tscram

import emqx_tpu.resources.db  # noqa: F401,E402  (registers the DB types)
import emqx_tpu_torch.resources.db  # noqa: F401,E402

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 30

REF = types.SimpleNamespace(
    name="ref", conn=jconn, redis=jredis, mysql=jmysql, pgsql=jpgsql,
    mongo=jmongo, ldap=jldap, bson=jbson, scram=jscram, authn=jauthn,
    authn_db=jauthn_db, authz=jauthz, authz_db=jauthz_db,
    RM=jresource.ResourceManager, Listener=JListener, Client=jclient.Client,
    MqttError=jclient.MqttError,
    node=lambda conf=None: JNode(conf or {}, use_device=False, name=NAME))
PORT = types.SimpleNamespace(
    name="port", conn=tconn, redis=tredis, mysql=tmysql, pgsql=tpgsql,
    mongo=tmongo, ldap=tldap, bson=tbson, scram=tscram, authn=tauthn,
    authn_db=tauthn_db, authz=tauthz, authz_db=tauthz_db,
    RM=tresource.ResourceManager, Listener=TListener, Client=tclient.Client,
    MqttError=tclient.MqttError,
    node=lambda conf=None: TNode(
        dict(conf or {}, broker={"device_route": False}), device="cpu",
        name=NAME))
PKGS = (REF, PORT)
F = tfake            # the servers every twin scenario runs against


class _Urandom:
    """A fixed stand-in for ``os.urandom`` in both SCRAM modules: one
    counter per run, so both runs draw the same nonces and salts."""

    def __init__(self):
        self.n = 0

    def urandom(self, k: int) -> bytes:
        self.n += 1
        return hashlib.sha512(b"%d" % self.n).digest()[:k]


@pytest.fixture()
def fixed(monkeypatch):
    """Install fresh fixed inputs before each package's run."""
    def reset():
        det = _Urandom()
        for mod in (jscram, tscram):
            monkeypatch.setattr(mod, "os", det)
        for mod in (jmongo, tmongo):
            monkeypatch.setattr(mod.MongoClient, "_req_ids",
                                itertools.count(1))
    return reset


def twin(fixed, scenario):
    """The scenario's transcript under the reference and the port (each
    in a fresh event loop with fresh fixed inputs); they must be
    equal."""
    outs = []
    for pkg in PKGS:
        fixed()
        outs.append(asyncio.run(asyncio.wait_for(scenario(pkg), TIMEOUT_S)))
    assert outs[0] == outs[1]
    return outs[1]


def received(*servers) -> list:
    """What each server received, one bytes object per connection."""
    return [[bytes(b) for b in s.received] for s in servers]


async def outcome(coro):
    """A call's value, or its error as (type name, message, code)."""
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001
        return ("error", type(e).__name__, str(e),
                getattr(e, "code", None))


def _hash(pw):     # sha256, salt prefix (the default algorithm config)
    return jpw.hash_password("sha256", pw.encode(), "s1", "prefix")


# ---------------------------------------------------------------------
# SCRAM
# ---------------------------------------------------------------------
class TestScram:
    @pytest.mark.parametrize("algo", ["sha1", "sha256", "sha512"])
    def test_roundtrip(self, fixed, algo):
        async def go(P):
            cred = P.scram.make_credentials("hunter2", algo)
            srv = P.scram.ScramServer({"bob": cred}.get, algo)
            cli = P.scram.ScramClient("bob", "hunter2", algo)
            first = cli.first()
            server_first = srv.challenge(first)
            final = cli.final(server_first)
            server_final = srv.finish(final)
            assert cli.verify_server(server_final)
            return [first, server_first, final, server_final, srv.username]
        twin(fixed, go)

    def test_wrong_password(self, fixed):
        async def go(P):
            srv = P.scram.ScramServer(
                {"bob": P.scram.make_credentials("right")}.get)
            cli = P.scram.ScramClient("bob", "wrong")
            sf = srv.challenge(cli.first())

            async def finish():
                return srv.finish(cli.final(sf))
            r = await outcome(finish())
            assert r[:2] == ("error", "ScramError")
            return [sf, r]
        twin(fixed, go)

    def test_unknown_user(self, fixed):
        async def go(P):
            srv = P.scram.ScramServer({}.get)
            cli = P.scram.ScramClient("nobody", "x")

            async def challenge():
                return srv.challenge(cli.first())
            r = await outcome(challenge())
            assert r[:2] == ("error", "ScramError")
            return r
        twin(fixed, go)

    def test_saslname_escaping(self, fixed):
        async def go(P):
            srv = P.scram.ScramServer(
                {"a,b=c": P.scram.make_credentials("p")}.get)
            cli = P.scram.ScramClient("a,b=c", "p")
            first = cli.first()
            sf = srv.challenge(first)
            final = srv.finish(cli.final(sf))
            assert srv.username == "a,b=c"
            return [first, sf, final, srv.username]
        twin(fixed, go)

    def test_client_rejects_tampered_nonce(self, fixed):
        async def go(P):
            cli = P.scram.ScramClient("bob", "p")
            cli.first()

            async def final():
                return cli.final("r=evilnonce,s=c2FsdA==,i=4096")
            r = await outcome(final())
            assert r[:2] == ("error", "ScramError")
            return r
        twin(fixed, go)


# ---------------------------------------------------------------------
# BSON
# ---------------------------------------------------------------------
class TestBson:
    def test_roundtrip(self, fixed):
        doc = {"s": "str", "i": 5, "big": 1 << 40, "f": 1.5, "b": True,
               "n": None, "bin": b"\x00\x01", "arr": [1, "two", 3.0],
               "nested": {"k": "v"}}

        async def go(P):
            raw = P.bson.encode(doc)
            assert P.bson.decode(raw) == doc
            return raw
        raw = twin(fixed, go)
        # each package reads the other's bytes
        assert jbson.decode(tbson.encode(doc)) == tbson.decode(raw) == doc

    def test_objectid(self, fixed):
        async def go(P):
            oid = P.bson.ObjectId(b"\x01" * 12)
            raw = P.bson.encode({"_id": oid})
            out = P.bson.decode(raw)
            assert out["_id"] == oid
            return [raw, out["_id"].raw, repr(out["_id"])]
        twin(fixed, go)


# ---------------------------------------------------------------------
# Redis
# ---------------------------------------------------------------------
class TestRedis:
    def test_commands_and_auth(self, fixed):
        async def go(P):
            srv = await F.FakeRedis(password="pw").start()
            srv.hashes["mqtt_user:alice"] = {"password_hash": "h",
                                             "salt": "s"}
            c = P.conn.RedisClient(port=srv.port, password="pw", database=1)
            await c.connect()
            out = [await c.ping(), await c.cmd(["HGETALL", "mqtt_user:alice"]),
                   await c.cmd(["HMGET", "mqtt_user:alice", "salt", "nope"])]
            assert out[1:] == [[b"password_hash", b"h", b"salt", b"s"],
                               [b"s", None]]
            await c.close()
            bad = P.conn.RedisClient(port=srv.port, password="wrong")
            out.append(await outcome(bad.connect()))
            assert out[-1][:2] == ("error", "RedisError")
            await bad.close()
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)

    def test_pool_survives_connect_rejection(self, fixed):
        async def go(P):
            srv = await F.FakeRedis(password="right").start()
            pw = ["bad"]

            def factory():
                p = pw.pop(0) if pw else "right"
                return P.conn.RedisClient(port=srv.port, password=p)
            pool = P.conn.ConnPool(factory, size=2)
            out = [await outcome(pool.start())]
            assert out[0][:2] == ("error", "RedisError")
            await pool.start()
            pw.append("bad")

            async def hold(c):
                await asyncio.sleep(0.05)
                return await c.ping()
            t1 = asyncio.ensure_future(pool.run(hold))
            await asyncio.sleep(0.01)
            out.append(await outcome(asyncio.wait_for(
                pool.run(lambda c: c.ping()), 2)))
            assert out[-1][:2] == ("error", "RedisError")
            out.append(await t1)
            r = await asyncio.gather(
                *[asyncio.wait_for(pool.run(lambda c: c.ping()), 2)
                  for _ in range(4)])
            assert all(r)
            out.append(r)
            await pool.stop()
            await srv.stop()
            return out + [sorted(x for x in received(srv)[0])]
        twin(fixed, go)

    def test_pool_reconnects(self, fixed):
        async def go(P):
            srv = await F.FakeRedis().start()
            pool = P.conn.ConnPool(lambda: P.conn.RedisClient(port=srv.port),
                                   size=2)
            await pool.start()
            out = [await pool.run(lambda c: c.ping())]
            for cl in pool._clients:
                cl._w.close()
                await cl._w.wait_closed()
            out.append(await pool.run(lambda c: c.ping()))
            assert out == [True, True]
            await pool.stop()
            await srv.stop()
            return out + received(srv) + [srv.opened]
        twin(fixed, go)


# ---------------------------------------------------------------------
# MySQL
# ---------------------------------------------------------------------
class TestMysql:
    def test_handshake_query(self, fixed):
        def handler(sql):
            if sql.startswith("SELECT"):
                return (["password_hash", "salt"], [["abc", None]])
            return None

        async def go(P):
            srv = await F.FakeMysql(username="mqtt", password="secret",
                                    handler=handler).start()
            c = P.conn.MysqlClient(port=srv.port, username="mqtt",
                                   password="secret", database="mqtt")
            await c.connect()
            out = [await c.ping(), await c.query(
                "SELECT password_hash, salt FROM users "
                "WHERE username = ? AND note = ?", ["alice", "o'brien"])]
            assert out[1] == (["password_hash", "salt"], [["abc", None]])
            sql_sent, params_sent = srv.prepared[-1]
            assert "o'brien" not in sql_sent and "?" in sql_sent
            assert params_sent == ["alice", "o'brien"]
            out.append(await c.query("UPDATE x SET y = 1"))
            assert out[-1] == ([], [])
            await c.close()
            await srv.stop()
            return out + [srv.prepared, srv.queries] + received(srv)
        twin(fixed, go)

    def test_access_denied(self, fixed):
        async def go(P):
            srv = await F.FakeMysql(username="u", password="right").start()
            c = P.conn.MysqlClient(port=srv.port, username="u",
                                   password="wrong")
            r = await outcome(c.connect())
            assert r[0] == "error" and r[1] == "MysqlError" and r[3] == 1045
            await c.close()
            await srv.stop()
            return [r] + received(srv)
        twin(fixed, go)


# ---------------------------------------------------------------------
# PostgreSQL
# ---------------------------------------------------------------------
class TestPgsql:
    @pytest.mark.parametrize("auth", ["trust", "cleartext", "md5", "scram"])
    def test_auth_modes(self, fixed, auth):
        async def go(P):
            srv = await F.FakePgsql(username="pg", password="pw", auth=auth,
                                    handler=lambda sql: (["a"], [["1"]])
                                    ).start()
            c = P.conn.PgsqlClient(port=srv.port, username="pg",
                                   password="pw")
            await c.connect()
            out = [await c.query("SELECT a FROM t WHERE u = $1", ["bob"]),
                   dict(c.parameters)]
            assert out[0] == (["a"], [["1"]])
            assert "'bob'" in srv.queries[-1]
            await c.close()
            await srv.stop()
            return out + [srv.queries] + received(srv)
        twin(fixed, go)

    def test_bind_params_no_resubstitution(self, fixed):
        async def go(P):
            out = P.pgsql.bind_params(
                "SELECT h FROM u WHERE n = $1 AND p = $2",
                ["alice", "pw with $1 inside"])
            assert out == ("SELECT h FROM u WHERE n = 'alice' "
                           "AND p = 'pw with $1 inside'")

            async def bad():
                return P.pgsql.bind_params("SELECT $3", ["a"])
            r = await outcome(bad())
            assert r[:2] == ("error", "ValueError")
            return [out, r, P.pgsql.escape("a\\b'c"), P.pgsql.escape(None),
                    P.pgsql.escape(b"\x01"), P.pgsql.escape(True)]
        twin(fixed, go)

    def test_bad_password_and_error(self, fixed):
        async def go(P):
            srv = await F.FakePgsql(username="pg", password="pw",
                                    auth="cleartext").start()
            bad = P.conn.PgsqlClient(port=srv.port, username="pg",
                                     password="nope")
            out = [await outcome(bad.connect())]
            assert out[0][:2] == ("error", "PgsqlError")
            await bad.close()

            def boom(sql):
                raise ValueError("syntax error at or near")
            srv2 = await F.FakePgsql(auth="trust", handler=boom).start()
            c = P.conn.PgsqlClient(port=srv2.port)
            await c.connect()
            out.append(await outcome(c.query("SELEC 1")))
            assert "syntax error" in out[-1][2]
            await c.close()
            await srv.stop()
            await srv2.stop()
            return out + received(srv, srv2)
        twin(fixed, go)


# ---------------------------------------------------------------------
# MongoDB
# ---------------------------------------------------------------------
class TestMongo:
    def test_auth_find_insert(self, fixed):
        async def go(P):
            srv = await F.FakeMongo(username="m", password="pw").start()
            srv.collections["mqtt_user"] = [
                {"username": "alice", "password_hash": "h", "salt": "s"}]
            c = P.conn.MongoClient(port=srv.port, username="m",
                                   password="pw", database="mqtt")
            await c.connect()
            out = [await c.ping(),
                   await c.find_one("mqtt_user", {"username": "alice"}),
                   await c.find_one("mqtt_user", {"username": "x"}),
                   await c.insert("mqtt_acl", [{"username": "alice",
                                                "topics": ["t/#"]}])]
            assert out[1]["password_hash"] == "h" and out[2] is None
            assert out[3] == 1
            await c.close()
            bad = P.conn.MongoClient(port=srv.port, username="m",
                                     password="no")
            out.append(await outcome(bad.connect()))
            assert out[-1][:2] == ("error", "MongoError")
            await bad.close()
            await srv.stop()
            return out + [srv.commands, srv.collections] + received(srv)
        twin(fixed, go)


# ---------------------------------------------------------------------
# The DB resources on the ResourceManager
# ---------------------------------------------------------------------
class TestDbResources:
    def test_create_health_query(self, fixed):
        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakeRedis().start()
            srv.hashes["k"] = {"f": "v"}
            res = await mgr.create("r1", "redis", {"port": srv.port})
            out = [res.status, await res.health_check(),
                   await res.query(["HGETALL", "k"]), mgr.list()]
            assert out[:3] == ["connected", True, [b"f", b"v"]]
            await mgr.remove("r1")
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)

    def test_disconnected_status(self, fixed):
        async def go(P):
            mgr = P.RM(P.node())
            res = await mgr.create("r2", "mysql",
                                   {"port": 1, "host": "127.0.0.1"})
            out = [res.status, await res.health_check(), res.last_error,
                   mgr.list()]
            assert out[:2] == ["disconnected", False]
            await mgr.remove("r2")
            return out + [mgr.list()]
        twin(fixed, go)


# ---------------------------------------------------------------------
# DB authn
# ---------------------------------------------------------------------
class TestDbAuthn:
    def test_parse_query(self, fixed):
        async def go(P):
            out = [P.authn_db.parse_query(
                "SELECT h FROM u WHERE n = ${mqtt-username} "
                "AND c = ${mqtt-clientid}", "mysql"),
                P.authn_db.parse_query(
                    "SELECT h FROM u WHERE n = ${mqtt-username}", "pgsql")]
            assert out[0][0].count("?") == 2 and "$1" in out[1][0]
            ci = {"username": "u", "clientid": "c", "peername": ("1.2.3.4",
                                                                 5),
                  "dn": "CN=x", "cn": "x"}
            out.append([P.authn_db.resolve_placeholder(n, ci, b"pw") for n in (
                "mqtt-username", "mqtt-clientid", "mqtt-password",
                "ip-address", "cert-subject", "cert-common-name", "other")])
            return out
        twin(fixed, go)

    def test_mysql_authn(self, fixed):
        def handler(sql, params=None):
            if params and "alice" in params:
                return (["password_hash", "salt", "is_superuser"],
                        [[_hash("w0nder"), "s1", "1"]])
            return (["password_hash", "salt", "is_superuser"], [])

        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakeMysql(handler=handler).start()
            res = await mgr.create("mysql1", "mysql",
                                   {"port": srv.port, "password": ""})
            a = P.authn_db.MysqlAuthenticator(
                res, "SELECT password_hash, salt, is_superuser FROM "
                     "mqtt_user WHERE username = ${mqtt-username}")
            out = [await a.authenticate_async(
                {"username": "alice", "clientid": "c1"}, b"w0nder"),
                await a.authenticate_async(
                    {"username": "alice", "clientid": "c1"}, b"bad"),
                await a.authenticate_async(
                    {"username": "ghost", "clientid": "c1"}, b"x")]
            assert out == [("ok", {"is_superuser": True}), ("deny", {}),
                           ("ignore", {})]
            await mgr.remove("mysql1")
            await srv.stop()
            return out + [srv.prepared] + received(srv)
        twin(fixed, go)

    def test_pgsql_authn(self, fixed):
        def handler(sql):
            if "'bob'" in sql:
                return (["password_hash", "salt"], [[_hash("pgpw"), "s1"]])
            return ([], [])

        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakePgsql(auth="trust", handler=handler).start()
            res = await mgr.create("pg1", "pgsql", {"port": srv.port})
            a = P.authn_db.PgsqlAuthenticator(
                res, "SELECT password_hash, salt FROM mqtt_user "
                     "WHERE username = ${mqtt-username}")
            out = [await a.authenticate_async({"username": "bob"}, b"pgpw"),
                   await a.authenticate_async({"username": "bob"}, b"no")]
            assert [v for v, _ in out] == ["ok", "deny"]
            await mgr.remove("pg1")
            await srv.stop()
            return out + [srv.queries] + received(srv)
        twin(fixed, go)

    def test_mongo_authn(self, fixed):
        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakeMongo().start()
            srv.collections["mqtt_user"] = [
                {"username": "carol", "password_hash": _hash("mongopw"),
                 "salt": "s1", "is_superuser": True}]
            res = await mgr.create("mg1", "mongo", {"port": srv.port})
            a = P.authn_db.MongoAuthenticator(res)
            out = [await a.authenticate_async({"username": "carol"},
                                              b"mongopw"),
                   await a.authenticate_async({"username": "carol"}, b"no"),
                   await a.authenticate_async({"username": "zed"}, b"x")]
            assert out == [("ok", {"is_superuser": True}), ("deny", {}),
                           ("ignore", {})]
            await mgr.remove("mg1")
            await srv.stop()
            return out + [srv.commands] + received(srv)
        twin(fixed, go)


# ---------------------------------------------------------------------
# DB authz
# ---------------------------------------------------------------------
class TestDbAuthz:
    def test_redis_source(self, fixed):
        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakeRedis().start()
            srv.hashes["mqtt_acl:alice"] = {"sensor/#": "subscribe",
                                            "cmd/alice": "all"}
            res = await mgr.create("rz", "redis", {"port": srv.port})
            s = P.authz_db.RedisSource(res, "HGETALL mqtt_acl:%u")
            ci = {"username": "alice", "clientid": "c1"}
            out = [await s.authorize_async(ci, "subscribe", "sensor/1"),
                   await s.authorize_async(ci, "publish", "sensor/1"),
                   await s.authorize_async(ci, "publish", "cmd/alice"),
                   await s.authorize_async({"username": "a b"}, "publish",
                                           "x")]
            assert out[:3] == ["allow", "nomatch", "allow"]
            await mgr.remove("rz")
            await srv.stop()
            return out + [srv.commands] + received(srv)
        twin(fixed, go)

    def test_sql_sources(self, fixed):
        rows = [["allow", "subscribe", "t/+"], ["deny", "all", "t/#"]]

        def handler(sql, params=None):
            hit = (params and "u1" in params) or "'u1'" in sql
            return (["permission", "action", "topic"],
                    rows if hit else [])

        async def go(P):
            mgr = P.RM(P.node())
            ms = await F.FakeMysql(handler=handler).start()
            ps = await F.FakePgsql(auth="trust", handler=handler).start()
            mres = await mgr.create("m", "mysql", {"port": ms.port})
            pres = await mgr.create("p", "pgsql", {"port": ps.port})
            ci = {"username": "u1", "clientid": "c1"}
            q = ("SELECT permission, action, topic FROM mqtt_acl "
                 "WHERE username = '%u'")
            out = []
            for src in (P.authz_db.MysqlSource(mres, q),
                        P.authz_db.PgsqlSource(pres, q)):
                out.append([await src.authorize_async(ci, "subscribe", "t/1"),
                            await src.authorize_async(ci, "publish", "t/1/x"),
                            await src.authorize_async(
                                {"username": "other"}, "publish", "t/1"),
                            await src.authorize_async(
                                {"clientid": "c"}, "publish", "t/1")])
                assert out[-1][:3] == ["allow", "deny", "nomatch"]
            await mgr.remove("m")
            await mgr.remove("p")
            await ms.stop()
            await ps.stop()
            return out + [ms.prepared, ps.queries] + received(ms, ps)
        twin(fixed, go)

    def test_mongo_source(self, fixed):
        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakeMongo().start()
            srv.collections["mqtt_acl"] = [
                {"username": "dave", "permission": "allow",
                 "action": "publish", "topics": ["up/%c", "up/shared"]}]
            res = await mgr.create("mz", "mongo", {"port": srv.port})
            s = P.authz_db.MongoSource(res, selector={"username": "%u"})
            ci = {"username": "dave", "clientid": "c9"}
            out = [await s.authorize_async(ci, "publish", "up/shared"),
                   await s.authorize_async(ci, "subscribe", "up/shared"),
                   await s.authorize_async(ci, "publish", "up/c9")]
            assert out[:2] == ["allow", "nomatch"]
            await mgr.remove("mz")
            await srv.stop()
            return out + [srv.commands] + received(srv)
        twin(fixed, go)


# ---------------------------------------------------------------------
# Full broker: SCRAM enhanced auth and MySQL authn over TCP
# ---------------------------------------------------------------------
class TestEnhancedAuthEndToEnd:
    def test_scram_connect(self, fixed):
        async def go(P):
            node = P.node({"authn": {"enable": True}})
            scram = P.authn_db.ScramAuthenticator()
            scram.add_user("neo", "thematrix")
            P.authn.AuthnChain(node, [scram], enable=True).load()
            lst = P.Listener(node, bind="127.0.0.1", port=0)
            await lst.start()
            out = []
            try:
                c = P.Client(port=lst.port, clientid="s1",
                             proto_ver=C.MQTT_V5)
                c.enable_scram("neo", "thematrix")
                ack = await c.connect()
                out += [ack.reason_code, c.scram_server_ok]
                assert out == [0, True]
                await c.subscribe("t/1", qos=1)
                await c.publish("t/1", b"hello", qos=1)
                out.append((await c.recv()).payload)
                out.append(await c.reauthenticate("neo", "thematrix"))
                assert out[2:] == [b"hello", True]
                await c.disconnect()
                bad = P.Client(port=lst.port, clientid="s2",
                               proto_ver=C.MQTT_V5)
                bad.enable_scram("neo", "wrongpw")
                out.append((await outcome(bad.connect()))[:3])
                assert out[-1][1] == "MqttError"
                await bad.close()
                unk = P.Client(port=lst.port, clientid="s3",
                               proto_ver=C.MQTT_V5)
                unk.conn_props = {"authentication_method": "SCRAM-SHA-999"}
                out.append((await outcome(unk.connect()))[:3])
                assert f"{C.RC_BAD_AUTHENTICATION_METHOD}" in out[-1][2]
                await unk.close()
            finally:
                await lst.stop()
            out.append(node.metrics.val("client.auth.success"))
            assert out[-1] >= 2
            return out
        twin(fixed, go)

    def test_mysql_authn_end_to_end(self, fixed):
        def handler(sql, params=None):
            if params and "alice" in params:
                return (["password_hash", "salt"],
                        [[_hash("w0nder"), "s1"]])
            return ([], [])

        async def go(P):
            node = P.node({"authn": {"enable": True}})
            lst = P.Listener(node, bind="127.0.0.1", port=0)
            await lst.start()
            mgr = P.RM(node)
            srv = await F.FakeMysql(handler=handler).start()
            res = await mgr.create("mysql-e2e", "mysql", {"port": srv.port})
            a = P.authn_db.MysqlAuthenticator(
                res, "SELECT password_hash, salt FROM mqtt_user "
                     "WHERE username = ${mqtt-username}")
            P.authn.AuthnChain(node, [a], enable=True).load()
            out = []
            try:
                ok = P.Client(port=lst.port, clientid="e1", username="alice",
                              password=b"w0nder")
                out.append((await ok.connect()).reason_code)
                await ok.disconnect()
                bad = P.Client(port=lst.port, clientid="e2",
                               username="alice", password=b"wrong")
                out.append((await outcome(bad.connect()))[:3])
                assert out == [0, out[1]] and out[1][1] == "MqttError"
                await bad.close()
            finally:
                await mgr.remove("mysql-e2e")
                await srv.stop()
                await lst.stop()
            return out + [srv.prepared] + received(srv)
        twin(fixed, go)


# ---------------------------------------------------------------------
# LDAP
# ---------------------------------------------------------------------
class TestLdap:
    def test_bind_search(self, fixed):
        async def go(P):
            L = P.ldap
            srv = await F.FakeLdap(
                binds={"cn=admin,dc=x": "secret", "": ""},
                entries=[
                    {"dn": "uid=alice,ou=mqtt,dc=x",
                     "uid": ["alice"], "userPassword": ["pw1"],
                     "objectClass": ["mqttUser"]},
                    {"dn": "uid=bob,ou=mqtt,dc=x",
                     "uid": ["bob"], "objectClass": ["mqttUser"]},
                ]).start()
            c = L.LdapClient(port=srv.port, bind_dn="cn=admin,dc=x",
                             bind_password="secret")
            await c.connect()
            out = [await c.search("ou=mqtt,dc=x", L.SCOPE_SUB,
                                  L.f_eq("uid", "alice")),
                   await c.search("ou=mqtt,dc=x", L.SCOPE_SUB,
                                  L.f_and(L.f_present("objectClass"),
                                          L.f_eq("uid", "bob"))),
                   await c.ping()]
            assert out[0][0]["userPassword"] == ["pw1"]
            assert [r["uid"] for r in out[1]] == [["bob"]]
            await c.close()
            bad = L.LdapClient(port=srv.port, bind_dn="cn=admin,dc=x",
                               bind_password="wrong")
            out.append(await outcome(bad.connect()))
            assert out[-1][1] == "LdapError" and out[-1][3] == 49
            await bad.close()
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)

    def test_ldap_resource(self, fixed):
        async def go(P):
            mgr = P.RM(P.node())
            srv = await F.FakeLdap(
                entries=[{"dn": "uid=u,dc=x", "uid": ["u"],
                          "objectClass": ["top"]}]).start()
            res = await mgr.create("ld", "ldap", {"port": srv.port})
            out = [res.status,
                   await res.query(("search", "dc=x", P.ldap.SCOPE_SUB,
                                    P.ldap.f_eq("uid", "u"))),
                   await res.health_check(),
                   await outcome(res.query(("nope",)))]
            assert out[0] == "connected" and out[1][0]["dn"] == "uid=u,dc=x"
            await mgr.remove("ld")
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)


class TestMysqlCachingSha2:
    def test_fast_path(self, fixed):
        async def go(P):
            srv = await F.FakeMysql(username="u8", password="pw8",
                                    plugin="caching_sha2_password",
                                    sha2_cached=True).start()
            c = P.conn.MysqlClient(port=srv.port, username="u8",
                                   password="pw8")
            await c.connect()
            out = [await c.ping()]
            await c.close()
            await srv.stop()
            return out + received(srv)
        assert twin(fixed, go)[0] is True

    def test_full_path_rsa(self, fixed):
        # RSA-OAEP pads with fresh random bytes and each server makes its
        # own key: the answers are compared, the encrypted bytes are not
        async def go(P):
            srv = await F.FakeMysql(username="u8", password="pw8",
                                    plugin="caching_sha2_password",
                                    sha2_cached=False).start()
            c = P.conn.MysqlClient(port=srv.port, username="u8",
                                   password="pw8")
            await c.connect()
            out = [await c.ping()]
            await c.close()
            await srv.stop()
            return out + [len(srv.received)]
        assert twin(fixed, go) == [True, 1]

    def test_wrong_password_denied(self, fixed):
        async def go(P):
            srv = await F.FakeMysql(username="u8", password="pw8",
                                    plugin="caching_sha2_password",
                                    sha2_cached=True).start()
            c = P.conn.MysqlClient(port=srv.port, username="u8",
                                   password="nope")
            r = await outcome(c.connect())
            assert r[1] == "MysqlError"
            await srv.stop()
            return [r] + received(srv)
        twin(fixed, go)


class TestRedisSentinel:
    def test_resolves_master_and_serves(self, fixed):
        async def go(P):
            master = await F.FakeRedis().start()
            master.hashes["k"] = {"f": "v"}
            sentinel = await F.FakeRedis(
                masters={"mymaster": ("127.0.0.1", master.port)}).start()
            c = P.redis.SentinelRedisClient([("127.0.0.1", sentinel.port)],
                                            "mymaster")
            await c.connect()
            out = [await c.ping(), await c.cmd(["HMGET", "k", "f"])]
            assert out == [True, [b"v"]]
            await c.close()
            await sentinel.stop()
            await master.stop()
            return out + received(master, sentinel)
        twin(fixed, go)

    def test_rejects_stale_master(self, fixed):
        async def go(P):
            replica = await F.FakeRedis(role="replica").start()
            sentinel = await F.FakeRedis(
                masters={"mymaster": ("127.0.0.1", replica.port)}).start()
            c = P.redis.SentinelRedisClient([("127.0.0.1", sentinel.port)],
                                            "mymaster")
            r = await outcome(c.connect())
            assert r[1] == "RedisError"
            await sentinel.stop()
            await replica.stop()
            # the message names the replica's ephemeral port
            return [r[:2], r[2].replace(str(replica.port), "<port>")] \
                + received(replica, sentinel)
        twin(fixed, go)

    def test_failover_follow_through_pool(self, fixed):
        async def go(P):
            m1 = await F.FakeRedis().start()
            m2 = await F.FakeRedis().start()
            m2.hashes["who"] = {"name": "m2"}
            masters = {"mymaster": ("127.0.0.1", m1.port)}
            sentinel = await F.FakeRedis(masters=masters).start()
            pool = P.conn.ConnPool(lambda: P.redis.SentinelRedisClient(
                [("127.0.0.1", sentinel.port)], "mymaster"), size=1)
            await pool.start()
            out = [await pool.run(lambda c: c.ping())]
            await m1.stop()
            masters["mymaster"] = ("127.0.0.1", m2.port)
            out.append(await pool.run(lambda c: c.cmd(["HMGET", "who",
                                                        "name"])))
            assert out == [True, [b"m2"]]
            await pool.stop()
            await sentinel.stop()
            await m2.stop()
            return out + received(m1, m2) + [len(sentinel.received)]
        twin(fixed, go)

    def test_dead_sentinel_skipped(self, fixed):
        async def go(P):
            master = await F.FakeRedis().start()
            sentinel = await F.FakeRedis(
                masters={"mymaster": ("127.0.0.1", master.port)}).start()
            dead = await F.FakeRedis().start()
            await dead.stop()
            c = P.redis.SentinelRedisClient(
                [("127.0.0.1", dead.port), ("127.0.0.1", sentinel.port)],
                "mymaster")
            await c.connect()
            out = [await c.ping()]
            await c.close()
            await sentinel.stop()
            await master.stop()
            return out + received(master, sentinel)
        assert twin(fixed, go)[0] is True

    def test_resource_sentinel_config(self, fixed):
        async def go(P):
            master = await F.FakeRedis().start()
            sentinel = await F.FakeRedis(
                masters={"ms1": ("127.0.0.1", master.port)}).start()
            mgr = P.RM(P.node())
            res = await mgr.create("r-sent", "redis", {
                "redis_type": "sentinel",
                "sentinels": [["127.0.0.1", sentinel.port]],
                "sentinel": "ms1"})
            out = [res.status, await res.query(["PING"])]
            assert out == ["connected", b"PONG"]
            await mgr.remove("r-sent")
            await sentinel.stop()
            await master.stop()
            return out + received(master, sentinel)
        twin(fixed, go)


def _ldap_fake():
    return F.FakeLdap(
        binds={"": "", "cn=svc,dc=x": "svcpw",
               "uid=alice,ou=people,dc=x": "wonder"},
        entries=[{"dn": "uid=alice,ou=people,dc=x",
                  "uid": ["alice"], "isSuperuser": ["1"]},
                 {"dn": "uid=bob,ou=people,dc=x", "uid": ["bob"]}])


class TestLdapAuthn:
    def test_bind_auth_in_chain(self, fixed):
        async def go(P):
            srv = await _ldap_fake().start()
            a = P.authn_db.LdapAuthenticator(
                port=srv.port, base_dn="dc=x",
                filter_tmpl="(uid=${mqtt-username})",
                bind_dn="cn=svc,dc=x", bind_password="svcpw")
            out = [await a.authenticate_async({"username": "alice"},
                                              b"wonder"),
                   await a.authenticate_async({"username": "alice"},
                                              b"wrong"),
                   await a.authenticate_async({"username": "ghost"}, b"x"),
                   await a.authenticate_async({"username": "alice"}, None)]
            assert out[:3] == [("ok", {"is_superuser": True}), ("deny", {}),
                               ("ignore", {})]
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)

    def test_chain_falls_through_when_unreachable(self, fixed):
        async def go(P):
            node = P.node()
            dead = await _ldap_fake().start()
            await dead.stop()
            builtin = P.authn.BuiltinDB()
            builtin.add_user("carol", "pw")
            chain = P.authn.AuthnChain(node, [
                P.authn_db.LdapAuthenticator(port=dead.port, base_dn="dc=x"),
                builtin], enable=True)
            _act, out = await chain.on_authenticate(
                {"username": "carol", "clientid": "c"},
                {"password": b"pw"})
            assert out["ok"] is True
            return out
        twin(fixed, go)

    def test_and_filter(self, fixed):
        async def go(P):
            srv = await _ldap_fake().start()
            a = P.authn_db.LdapAuthenticator(
                port=srv.port, base_dn="dc=x",
                filter_tmpl="(&(uid=${mqtt-username})(uid=alice))")
            out = [await a.authenticate_async({"username": "alice"},
                                              b"wonder")]
            bad = P.authn_db.LdapAuthenticator(port=srv.port,
                                               filter_tmpl="uid=x")
            out.append(await bad.authenticate_async({"username": "alice"},
                                                    b"wonder"))
            assert out == [("ok", {"is_superuser": True}), ("ignore", {})]
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)


class TestMysqlPreparedEdges:
    def test_param_mismatch_leaves_connection_usable(self, fixed):
        def handler(sql, params=None):
            return (["a"], [["1"]])

        async def go(P):
            srv = await F.FakeMysql(handler=handler).start()
            c = P.conn.MysqlClient(port=srv.port)
            await c.connect()
            out = [await outcome(c.query(
                "SELECT a FROM t WHERE x = ? AND y = ?",
                ["only-one", "two", "three"]))]
            assert out[0][:2] == ("error", "ValueError")
            out += [await c.query("SELECT a FROM t WHERE x = ?", ["v"]),
                    await c.ping()]
            assert out[1:] == [(["a"], [["1"]]), True]
            await c.close()
            await srv.stop()
            return out + received(srv)
        twin(fixed, go)

    def test_binary_temporal_decode(self, fixed):
        async def go(P):
            M = P.mysql
            out = [
                M._decode_bin_datetime(struct.pack(
                    "<HBBBBBI", 2026, 7, 30, 12, 34, 56, 789), 0, 11,
                    date_only=False),
                M._decode_bin_datetime(struct.pack("<HBB", 2026, 1, 2), 0,
                                       4, date_only=True),
                M._decode_bin_datetime(b"", 0, 0, date_only=False),
                M._decode_bin_time(struct.pack("<BIBBB", 1, 1, 2, 10, 5), 0,
                                   8),
                M._decode_bin_time(struct.pack("<BIBBBI", 0, 0, 1, 2, 3, 4),
                                   0, 12)]
            assert out[0] == ("2026-07-30 12:34:56.000789", 11)
            assert out[1][0] == "2026-01-02"
            assert out[2][0] == "0000-00-00 00:00:00"
            assert out[3][0] == "-26:10:05"
            return out + [M.escape("a'b\n"), M.escape(None),
                          M.bind_params("x = ? AND y = ?", [1, "z"])]
        twin(fixed, go)


class TestRedisCluster:
    def test_slot_hash_vectors(self, fixed):
        keys = ["foo", "bar", "{user1000}.following", "user1000", "{}.x",
                b"\xff\x00", "a{b}c{d}"]

        async def go(P):
            R = P.redis
            out = [R.crc16(b"123456789"), [R.key_slot(k) for k in keys]]
            assert out[0] == 0x31C3
            assert out[1][:2] == [12182, 5061]
            assert out[1][2] == out[1][3]
            assert out[1][4] == R.crc16(b"{}.x") % 16384
            return out
        twin(fixed, go)

    @staticmethod
    def _two_node_slots(a, b):
        return [(0, 8191, "127.0.0.1", a.port),
                (8192, 16383, "127.0.0.1", b.port)]

    def test_routes_by_slot(self, fixed):
        async def go(P):
            a, b = await F.FakeRedis().start(), await F.FakeRedis().start()
            a.cluster_slots = b.cluster_slots = self._two_node_slots(a, b)
            c = P.redis.ClusterRedisClient([("127.0.0.1", a.port)])
            await c.connect()
            out = [await c.cmd(["SET", "bar", "low"]),
                   await c.cmd(["SET", "foo", "high"]),
                   dict(a.kv), dict(b.kv), await c.cmd(["GET", "foo"]),
                   await c.ping()]
            assert out == [b"OK", b"OK", {"bar": "low"}, {"foo": "high"},
                           b"high", True]
            await c.close()
            await a.stop()
            await b.stop()
            return out + received(a, b)
        twin(fixed, go)

    def test_moved_refreshes_topology(self, fixed):
        async def go(P):
            a, b = await F.FakeRedis().start(), await F.FakeRedis().start()
            a.cluster_slots = [(0, 16383, "127.0.0.1", a.port)]
            b.cluster_slots = self._two_node_slots(a, b)
            c = P.redis.ClusterRedisClient([("127.0.0.1", a.port)])
            await c.connect()
            b.kv["foo"] = "moved-here"
            a.redirects["foo"] = ("MOVED", 12182, "127.0.0.1", b.port)
            a.cluster_slots = self._two_node_slots(a, b)
            out = [await c.cmd(["GET", "foo"])]
            n_gets_a = sum(1 for x in a.commands if x[0].upper() == b"GET")
            out.append(await c.cmd(["GET", "foo"]))
            assert out == [b"moved-here"] * 2
            assert sum(1 for x in a.commands
                       if x[0].upper() == b"GET") == n_gets_a
            await c.close()
            await a.stop()
            await b.stop()
            return out + [a.commands, b.commands]
        twin(fixed, go)

    def test_ask_redirect_sends_asking(self, fixed):
        async def go(P):
            a, b = await F.FakeRedis().start(), await F.FakeRedis().start()
            a.cluster_slots = b.cluster_slots = \
                [(0, 16383, "127.0.0.1", a.port)]
            c = P.redis.ClusterRedisClient([("127.0.0.1", a.port)])
            await c.connect()
            b.kv["foo"] = "importing"
            a.redirects["foo"] = ("ASK", 12182, "127.0.0.1", b.port)
            b.ask_required.add("foo")
            out = [await c.cmd(["GET", "foo"]), [b"ASKING"] in b.commands,
                   len(c._ranges), c._ranges[0][2] == ("127.0.0.1", a.port)]
            assert out == [b"importing", True, 1, True]
            await c.close()
            await a.stop()
            await b.stop()
            return out + received(a, b)
        twin(fixed, go)

    def test_node_death_reroutes(self, fixed):
        async def go(P):
            a, b = await F.FakeRedis().start(), await F.FakeRedis().start()
            a.cluster_slots = [(0, 16383, "127.0.0.1", a.port)]
            b.cluster_slots = [(0, 16383, "127.0.0.1", b.port)]
            c = P.redis.ClusterRedisClient([("127.0.0.1", a.port),
                                            ("127.0.0.1", b.port)])
            await c.connect()
            out = [await c.cmd(["SET", "k", "1"]), dict(a.kv)]
            await a.stop()
            b.kv["k"] = "2"
            out.append(await c.cmd(["GET", "k"]))
            assert out == [b"OK", {"k": "1"}, b"2"]
            await c.close()
            await b.stop()
            return out + [a.commands, b.commands]
        twin(fixed, go)

    def test_resource_cluster_config(self, fixed):
        async def go(P):
            a = await F.FakeRedis().start()
            a.cluster_slots = [(0, 16383, "127.0.0.1", a.port)]
            mgr = P.RM(P.node())
            res = await mgr.create("r-clu", "redis", {
                "redis_type": "cluster",
                "cluster_nodes": [["127.0.0.1", a.port]]})
            out = [await res.query(["SET", "x", "y"]), dict(a.kv)]
            assert out == [b"OK", {"x": "y"}]
            # no seed node: the pool's first connect fails, the resource
            # is made all the same and stays disconnected
            bad = await mgr.create("r-none", "redis", {
                "redis_type": "cluster", "host": ""})
            out += [bad.status, bad.last_error]
            await mgr.remove("r-clu")
            await mgr.remove("r-none")
            await a.stop()
            return out + received(a)
        twin(fixed, go)


# ---------------------------------------------------------------------
# The port's servers answer as tests/fake_db.py's
# ---------------------------------------------------------------------
class _Proxy:
    """A TCP relay that records both directions of every connection."""

    def __init__(self, upstream: int):
        self.upstream = upstream
        self.conns: list = []
        self._server = None
        self.port = 0

    async def start(self) -> "_Proxy":
        self._server = await asyncio.start_server(self._on, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        self._server.close()

    async def _on(self, r, w):
        ur, uw = await asyncio.open_connection("127.0.0.1", self.upstream)
        rec = [bytearray(), bytearray()]      # client->server, server->client
        self.conns.append(rec)

        async def pump(src, dst, buf):
            try:
                while True:
                    data = await src.read(65536)
                    if not data:
                        break
                    buf += data
                    dst.write(data)
                    await dst.drain()
            except (ConnectionError, OSError):
                pass
            finally:
                dst.close()
        await asyncio.gather(pump(r, uw, rec[0]), pump(ur, w, rec[1]))


async def _redis_script(P, port):
    c = P.conn.RedisClient(port=port, password="pw", database=2)
    await c.connect()
    out = [await c.ping(), await c.cmd(["HGETALL", "h"]),
           await c.cmd(["HMGET", "h", "a", "z"]),
           await c.cmd(["SET", "k", "v"]), await c.cmd(["GET", "k"]),
           await c.cmd(["CLUSTER", "SLOTS"]), await c.cmd(["ROLE"]),
           await c.cmd(["SENTINEL", "get-master-addr-by-name", "m"]),
           await outcome(c.cmd(["NOPE"]))]
    await c.close()
    bad = P.conn.RedisClient(port=port, password="x")
    out.append(await outcome(bad.connect()))
    return out


async def _mysql_script(P, port):
    out = []
    for pw in ("pw", "bad"):
        c = P.conn.MysqlClient(port=port, username="u", password=pw,
                              database="db")
        r = await outcome(c.connect())
        out.append(r)
        if r[0] == "ok":
            out += [await c.ping(), await c.query("SELECT a, b FROM t"),
                    await c.query("SELECT a FROM t WHERE x = ? AND y = ?",
                                  ["v", 3]),
                    await c.query("UPDATE t SET a = 1")]
            await c.close()
    return out


async def _pgsql_script(P, port):
    out = []
    for pw in ("pw", "bad"):
        c = P.conn.PgsqlClient(port=port, username="u", password=pw)
        r = await outcome(c.connect())
        out.append(r)
        if r[0] == "ok":
            out += [await c.query("SELECT a FROM t WHERE u = $1", ["o'x"]),
                    await outcome(c.query("SELECT boom")), await c.ping()]
            await c.close()
    return out


async def _mongo_script(P, port):
    out = []
    for pw in ("pw", "bad"):
        c = P.conn.MongoClient(port=port, username="m", password=pw)
        r = await outcome(c.connect())
        out.append(r)
        if r[0] == "ok":
            out += [await c.ping(), await c.insert("c", [{"k": 1, "v": "a"}]),
                    await c.find("c", {"k": 1}),
                    await outcome(c.command({"bogus": 1}))]
            await c.close()
    return out


async def _ldap_script(P, port):
    L = P.ldap
    out = []
    for pw in ("pw", "bad"):
        c = L.LdapClient(port=port, bind_dn="cn=a", bind_password=pw)
        r = await outcome(c.connect())
        out.append(r)
        if r[0] == "ok":
            out += [await c.search("dc=x", L.SCOPE_SUB,
                                   L.f_and(L.f_eq("uid", "u"),
                                           L.f_present("cn"))),
                    await c.ping()]
            await c.close()
    return out


def _pg_handler(sql):
    if "boom" in sql:
        raise ValueError("no such column boom")
    return (["a"], [["1"], [None]])


SERVERS = {
    "redis": (lambda m: m.FakeRedis(password="pw"), _redis_script,
              lambda s: (s.hashes.update({"h": {"a": "1", "b": "2"}}),
                         setattr(s, "cluster_slots",
                                 [(0, 16383, "127.0.0.1", 7000)]),
                         setattr(s, "masters", {"m": ("10.0.0.1", 6380)}))),
    "mysql": (lambda m: m.FakeMysql(
        username="u", password="pw",
        handler=lambda sql, params=None: (["a", "b"], [["1", None],
                                                       [params, "x" * 300]])),
        _mysql_script, lambda s: None),
    "pgsql": (lambda m: m.FakePgsql(username="u", password="pw",
                                    handler=_pg_handler),
              _pgsql_script, lambda s: None),
    "mongo": (lambda m: m.FakeMongo(username="m", password="pw"),
              _mongo_script, lambda s: None),
    "ldap": (lambda m: m.FakeLdap(
        binds={"cn=a": "pw"},
        entries=[{"dn": "uid=u,dc=x", "uid": ["u"], "cn": ["U"]},
                 {"dn": "uid=v,dc=x", "uid": ["v"], "cn": ["V"]}]),
             _ldap_script, lambda s: None),
}


async def _through_proxy(mod, P, kind):
    """Script `kind` with package P's clients through a recording proxy
    to module `mod`'s server; (answers, [(request, reply) bytes])."""
    make, script, seed = SERVERS[kind]
    srv = make(mod)
    seed(srv)
    await srv.start()
    px = await _Proxy(srv.port).start()
    out = await script(P, px.port)
    await px.stop()
    await srv.stop()
    return out, [(bytes(a), bytes(b)) for a, b in px.conns]


@pytest.mark.parametrize("kind", sorted(SERVERS))
def test_fake_replies_equal_reference_fakes(fixed, kind):
    """The same client script (the port's clients) through a recording
    proxy to ``tests/fake_db.py``'s server and to the port's copy: the
    same request bytes get the same reply bytes, connection by
    connection, and the script sees the same answers."""
    outs = []
    for mod in (jfake, tfake):
        fixed()
        outs.append(asyncio.run(asyncio.wait_for(
            _through_proxy(mod, PORT, kind), TIMEOUT_S)))
    (ans_j, conns_j), (ans_t, conns_t) = outs
    assert ans_j == ans_t
    assert len(conns_j) == len(conns_t) >= 2
    assert conns_j == conns_t
    assert all(req and rep for req, rep in conns_t)


@pytest.mark.parametrize("kind", sorted(SERVERS))
def test_fakes_serve_the_reference_clients(fixed, kind):
    """Each port server answers the reference's clients as the port's:
    the script above with the reference's connector classes gives the
    same answers and the same bytes on the wire."""
    outs = []
    for P in PKGS:
        fixed()
        outs.append(asyncio.run(asyncio.wait_for(
            _through_proxy(tfake, P, kind), TIMEOUT_S)))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------
# The database arms booted from a config file
# ---------------------------------------------------------------------
def _boot_node(P, tmp_path, text: str):
    """A node of package P from a config file holding `text` (the port's
    host-only node: these tests run on the CPU)."""
    path = tmp_path / f"emqx-{P.name}.conf"
    path.write_text(text + "\nbroker.device_route = false\n")
    if P is REF:
        return JNode.from_config_file(str(path), use_device=False, name=NAME)
    return TNode.from_config_file(str(path), device="cpu", name=NAME)


def test_boot_db_backed_authn_from_config(fixed, tmp_path):
    """The twin of ``tests/test_boot.py``'s case: a config-declared MySQL
    authenticator builds its typed resource from the same block and
    enforces CONNECT credentials against the fake server; stopping the
    listeners closes the resource and every connection it made."""
    def handler(sql):
        assert "?" in sql, f"expected a prepared statement, got {sql!r}"
        return (["password_hash", "salt", "is_superuser"],
                [[_hash("dbpw"), "s1", "0"]])

    async def go(P):
        srv = await F.FakeMysql(handler=handler).start()
        node = _boot_node(P, tmp_path, f"""
        listeners {{ t {{ type = tcp, bind = "127.0.0.1", port = 0 }} }}
        authn {{
          enable = true
          chain = [ {{ mechanism = password_based, backend = mysql,
                       port = {srv.port}, password = "",
                       query = "SELECT password_hash, salt, is_superuser \\
FROM mqtt_user WHERE username = ${{mqtt-username}}" }} ]
        }}
        """)
        apps = await node.start_apps()
        out = [[type(a).__name__ for a in apps], node.resources.list()]
        assert "AuthnChain" in out[0]
        lst = P.Listener(node, bind="127.0.0.1", port=0)
        await lst.start()
        node.listeners.append(lst)
        bad = P.Client(port=lst.port, clientid="b", username="dbu",
                       password=b"wrong")
        out.append((await outcome(bad.connect(timeout=5)))[:3])
        assert out[-1][1] == "MqttError"
        good = P.Client(port=lst.port, clientid="g", username="dbu",
                        password=b"dbpw")
        out.append((await good.connect()).reason_code)
        await good.disconnect()
        await node.stop_listeners()
        out.append(dict(node.resources.instances))
        assert out[-1] == {}
        await tfake._closed(srv)
        out.append((srv.opened, srv.closed))
        await srv.stop()
        return out + [srv.prepared]
    out = twin(fixed, go)
    opened, closed = out[-2]
    assert opened == closed >= 1


@pytest.mark.parametrize("block", ["authn", "authz"])
def test_mongodb_arm_cannot_boot(fixed, tmp_path, block):
    """A reference defect the port keeps: the boot maps ``mongodb`` to
    the resource type ``mongodb`` while the Mongo resource registers as
    ``mongo``, so a mongodb authn backend or authz source raises
    ``ValueError: unknown resource type mongodb`` in both packages, after
    the apps before it booted (the library classes still work over a
    ``mongo`` resource: ``TestDbAuthn.test_mongo_authn``)."""
    arm = ("authn { enable = true, chain = [ { mechanism = password_based,"
           " backend = mongodb, port = %d } ] }" if block == "authn" else
           "authz { sources = [ { type = mongodb, port = %d } ] }")

    async def go(P):
        srv = await F.FakeMongo().start()
        node = _boot_node(P, tmp_path, "retainer { enable = true }\n"
                          + arm % srv.port)
        r = await outcome(node.start_apps())
        out = [r, [type(a).__name__ for a in node._apps],
               node.resources.list(), srv.opened]
        await node.stop_listeners()
        await srv.stop()
        return out
    out = twin(fixed, go)
    assert out[0] == ("error", "ValueError", "unknown resource type mongodb",
                      None)
    assert out[1:] == [["Retainer", "DelayedPublish"], [], 0]


def test_redis_authn_backend_answers_ignore(fixed, tmp_path):
    """A reference defect the port keeps: a ``redis`` authn backend builds
    a ``PgsqlAuthenticator`` over the Redis resource. Its block must carry
    ``query`` (else ``KeyError``); at CONNECT the resource sends the
    ``("sql", query, params)`` request as a Redis command, the server
    refuses it, the authenticator answers ``ignore`` and the chain falls
    through to the built-in users."""
    async def go(P):
        srv = await F.FakeRedis().start()
        arm = ("{ mechanism = password_based, backend = redis, port = %d%s }"
               % (srv.port, ", query = \"SELECT h FROM u WHERE n = "
                  "${mqtt-username}\""))
        node = _boot_node(P, tmp_path, f"""
        authn {{ enable = true, chain = [ {arm},
          {{ mechanism = password_based, backend = built_in_database }} ] }}
        """)
        await node.start_apps()
        chain = node.get_app(P.authn.AuthnChain)
        db_arm, builtin = chain.authenticators
        builtin.add_user("carol", "pw")
        out = [type(db_arm).__name__, type(db_arm.resource).__name__,
               await db_arm.authenticate_async({"username": "carol"}, b"pw"),
               (await chain.on_authenticate(
                   {"username": "carol", "clientid": "c"},
                   {"password": b"pw"}))[1]]
        await node.stop_listeners()
        await srv.stop()
        bare = _boot_node(P, tmp_path, """
        authn { enable = true, chain = [ { mechanism = password_based,
          backend = redis, port = 9 } ] }""")
        r = await outcome(bare.start_apps())
        await bare.stop_listeners()
        return out + [r[:3], srv.commands]
    out = twin(fixed, go)
    assert out[:3] == ["PgsqlAuthenticator", "RedisResource", ("ignore", {})]
    assert out[3]["ok"] is True
    assert out[4] == ("error", "KeyError", "'query'")
    assert out[5][-1][0] == b"sql"
