"""Port vs JAX reference: authentication and authorization.

The same inputs go through the reference's ``emqx_tpu/utils/passwd.py``,
``utils/scram.py``, ``apps/authn.py``, ``apps/authn_db.py`` and
``apps/authz.py`` and through the port's copies, and must give equal
outputs: password hashes for every algorithm and salt position, a SCRAM
exchange with both packages' nonces and salts fixed, the built-in user
store (its records carried across by ``convert.load_auth_records``), JWT
and HTTP authenticators (the HTTP transport injected), the chain's
ok / ignore / deny order, ACL rules over hypothesis-drawn (who, action,
topic) triples, the decision cache under a scripted clock, and twin
nodes over live TCP: equal CONNACK, SUBACK and PUBACK reason codes, AUTH
packets, deliveries and ``client.*`` counters, the v5 SCRAM CONNECT and
a re-authentication included. Inputs follow the reference's
``tests/test_authn_authz.py`` and the SCRAM case of
``tests/test_connectors_db.py``.
"""

import asyncio
import base64
import hashlib
import hmac
import json
import types

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from emqx_tpu.apps import authn as jauthn
from emqx_tpu.apps import authn_db as jauthn_db
from emqx_tpu.apps import authz as jauthz
from emqx_tpu.apps import boot as jboot
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.utils import http as jhttp
from emqx_tpu.utils import passwd as jpw
from emqx_tpu.utils import scram as jscram
from emqx_tpu_torch import convert
from emqx_tpu_torch.apps import authn as tauthn
from emqx_tpu_torch.apps import authn_db as tauthn_db
from emqx_tpu_torch.apps import authz as tauthz
from emqx_tpu_torch.apps import boot as tboot
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client, MqttError
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.utils import http as thttp
from emqx_tpu_torch.utils import passwd as tpw
from emqx_tpu_torch.utils import scram as tscram

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 60

REF = types.SimpleNamespace(
    name="ref", pw=jpw, scram=jscram, authn=jauthn, authn_db=jauthn_db,
    authz=jauthz, boot=jboot, http=jhttp, Listener=JListener,
    node=lambda conf=None: JNode(conf or {}, use_device=False, name=NAME))
PORT = types.SimpleNamespace(
    name="port", pw=tpw, scram=tscram, authn=tauthn, authn_db=tauthn_db,
    authz=tauthz, boot=tboot, http=thttp, Listener=TListener,
    node=lambda conf=None: TNode(conf or {}, device="cpu", name=NAME))
PKGS = (REF, PORT)


def both(script):
    """The script's result under the reference and under the port."""
    return [script(pkg) for pkg in PKGS]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def jwt_make(payload, secret: str, alg: str = "HS256",
             header_alg=None) -> str:
    def b64(b):
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()
    head = b64(json.dumps({"alg": header_alg or alg, "typ": "JWT"}).encode())
    body = b64(json.dumps(payload).encode())
    digest = {"HS256": hashlib.sha256, "HS384": hashlib.sha384,
              "HS512": hashlib.sha512}[alg]
    sig = b64(hmac.new(secret.encode(), f"{head}.{body}".encode(),
                       digest).digest())
    return f"{head}.{body}.{sig}"


# ---------------------------------------------------------------------
# passwd
# ---------------------------------------------------------------------
HASHED = ("plain", "md5", "sha", "sha256", "sha512", "pbkdf2")
PASSWORDS = (b"", b"secret", b"p\xc3\xa4ss", b"x" * 200, b"\xff\xfe")


@pytest.mark.parametrize("position", ["prefix", "suffix"])
@pytest.mark.parametrize("algo", HASHED)
def test_passwd_hashes_equal_reference(algo, position):
    """Every algorithm at either salt position hashes every password to
    the same string in both packages, and both check it the same way
    (right password, wrong password, none)."""
    def script(pkg):
        def check(*a, **kw):
            # a plain hash with non-ASCII characters makes
            # hmac.compare_digest raise: the same error in both
            try:
                return pkg.pw.check_password(*a, **kw)
            except TypeError as e:
                return str(e)
        out = []
        for salt in ("", "salt123", "s" * 33):
            for pw in PASSWORDS:
                h = pkg.pw.hash_password(algo, pw, salt, position,
                                         iterations=64)
                out.append((h, check(algo, h, pw, salt, position,
                                     iterations=64),
                            check(algo, h, pw + b"!", salt, position,
                                  iterations=64),
                            check(algo, h, None, salt, position)))
        return out
    want, got = both(script)
    assert got == want


def test_passwd_bcrypt_and_unknown_equal_reference():
    """bcrypt is optional in both (absent on these hosts): hashing raises
    and checking refuses; an unknown algorithm raises in both."""
    def script(pkg):
        out = [pkg.pw.ALGORITHMS, pkg.pw._bcrypt is None,
               len(pkg.pw.gen_salt()), len(pkg.pw.gen_salt(4))]
        for algo in ("bcrypt", "md4"):
            try:
                pkg.pw.hash_password(algo, b"p", "s")
                out.append("ok")
            except ValueError as e:
                out.append(str(e))
        out.append(pkg.pw.check_password("bcrypt", "$2b$x", b"p"))
        return out
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# SCRAM
# ---------------------------------------------------------------------
SALT = bytes(range(16))
CNONCE = "fyko+d2lbbFgONRv9qkxdawL"
SNONCE = "3rfcNHYJY1ZVvWVs7j"


def scram_exchange(pkg, algo: str, user: str, password: str,
                   tried: str) -> list:
    """One exchange with the nonces and the salt fixed; every message,
    or the error where one side refuses."""
    cred = pkg.scram.make_credentials(password, algo, 512, salt=SALT)
    out = [sorted((k, v) for k, v in cred.items())]
    client = pkg.scram.ScramClient(user, tried, algo, nonce=CNONCE)
    server = pkg.scram.ScramServer(
        lambda u: cred if u == user else None, algo, nonce=SNONCE)
    first = client.first()
    out.append(first)
    try:
        sf = server.challenge(first)
        out.append(sf)
        cf = client.final(sf)
        out.append(cf)
        final = server.finish(cf)
        out.append(final)
        out.append(client.verify_server(final))
        out.append(client.verify_server("e=other-error"))
    except pkg.scram.ScramError as e:
        out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("algo", ["sha1", "sha256", "sha512"])
@pytest.mark.parametrize("case", ["ok", "bad_password", "odd_name"])
def test_scram_exchange_equal_reference(algo, case):
    """Client-first, server-first, client-final and server-final are equal
    byte for byte with the nonces and the salt fixed; a wrong password is
    refused with the same error; a name with ',' and '=' is escaped the
    same way."""
    user = "us,er=1" if case == "odd_name" else "user"
    tried = "wrong" if case == "bad_password" else "pencil"
    want, got = both(lambda pkg: scram_exchange(pkg, algo, user, "pencil",
                                                tried))
    assert got == want
    assert (("error", "invalid proof") in got) == (case == "bad_password")


@pytest.mark.parametrize("first", [
    "p=tls-unique,,n=user,r=abc", "n,,r=abc", "n,a=admin,n=user,r=abc",
    "n,,n=ghost,r=abc", "y,,n=user,r=abc"])
def test_scram_server_refusals_equal_reference(first):
    """Channel binding, a malformed first message, an authzid header, an
    unknown user and the 'y' flag: the same answer or the same error."""
    def script(pkg):
        cred = pkg.scram.make_credentials("pencil", "sha256", 64, salt=SALT)
        server = pkg.scram.ScramServer(
            lambda u: cred if u == "user" else None, "sha256", nonce=SNONCE)
        try:
            return server.challenge(first), server.username
        except pkg.scram.ScramError as e:
            return "error", str(e)
    want, got = both(script)
    assert got == want


def scram_users(pkg, algo="sha256"):
    """A ScramAuthenticator with two users; the salts drawn from a seeded
    generator in place of os.urandom."""
    a = pkg.authn_db.ScramAuthenticator(algo, iteration_count=256)
    orig = pkg.scram.os.urandom
    pkg.scram.os.urandom = lambda n: bytes((7 * i + 3) % 256
                                           for i in range(n))
    try:
        a.add_user("neo", "thematrix", is_superuser=True)
        a.add_user("trin", "ity")
    finally:
        pkg.scram.os.urandom = orig
    return a


@pytest.mark.parametrize("algo", ["sha1", "sha256", "sha512"])
def test_scram_authenticator_equal_reference(algo):
    """ScramAuthenticator's user API and both halves of its enhanced-auth
    surface: the challenge, the final message and the extra it hands the
    channel; a bad proof raises in both."""
    def script(pkg):
        a = scram_users(pkg, algo)
        out = [a.name, a.mechanism, a.list_users(),
               sorted(a.lookup_user("neo")), a.lookup_user("ghost"),
               a.authenticate({"username": "neo"}, b"thematrix")]
        for user, pw in (("neo", "thematrix"), ("trin", "wrong")):
            c = pkg.scram.ScramClient(user, pw, algo, nonce=CNONCE)
            orig = pkg.scram._nonce
            pkg.scram._nonce = lambda: SNONCE
            try:
                ch, state = a.begin_enhanced_auth(c.first().encode())
            finally:
                pkg.scram._nonce = orig
            out.append(ch)
            try:
                out.append(a.continue_enhanced_auth(
                    c.final(ch.decode()).encode(), state))
            except pkg.scram.ScramError as e:
                out.append(("error", str(e)))
        out.append((a.delete_user("trin"), a.delete_user("trin"),
                    a.list_users()))
        return out
    want, got = both(script)
    assert got == want


def test_convert_carries_scram_credentials():
    """The reference's SCRAM credentials, loaded into the port's store by
    convert.load_auth_records, accept and refuse the same passwords."""
    ref = scram_users(REF)
    ref.add_user("morph", "eus")          # a salt from os.urandom
    port = tauthn_db.ScramAuthenticator("sha256", iteration_count=256)
    convert.load_auth_records(scram=port, credentials=ref._users)
    assert sorted(port.list_users()) == sorted(ref.list_users())
    for user, pw in (("neo", "thematrix"), ("neo", "x"), ("morph", "eus"),
                     ("morph", "eus "), ("trin", "ity")):
        outs = []
        for pkg, a in ((REF, ref), (PORT, port)):
            c = pkg.scram.ScramClient(user, pw, "sha256", nonce=CNONCE)
            ch, state = a.begin_enhanced_auth(c.first().encode())
            try:
                final, extra = a.continue_enhanced_auth(
                    c.final(ch.decode()).encode(), state)
                outs.append((c.verify_server(final.decode()), extra))
            except pkg.scram.ScramError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], (user, pw)


# ---------------------------------------------------------------------
# BuiltinDB, JWT, HTTP
# ---------------------------------------------------------------------
@pytest.mark.parametrize("position", ["prefix", "suffix"])
@pytest.mark.parametrize("algo", HASHED)
@pytest.mark.parametrize("id_type", ["username", "clientid"])
def test_builtin_db_equal_reference(id_type, algo, position):
    """The reference's user records, carried into the port's store by
    convert.load_auth_records, give the same verdicts: right and wrong
    passwords, unknown users, no id, superusers; then the same user API
    (update, delete, lookup) on both."""
    ref = jauthn.BuiltinDB(id_type, algo, position)
    for k in range(6):
        ref.add_user(f"u{k}", f"pw{k}", is_superuser=k % 3 == 0)
    port = tauthn.BuiltinDB(id_type, algo, position)
    convert.load_auth_records(builtin=port, users=ref._users)
    for uid in ("u0", "u1", "u5", "ghost", "", None):
        for pw in (b"pw0", b"pw1", b"pw5", b"", None):
            ci = {id_type: uid}
            assert port.authenticate(ci, pw) == ref.authenticate(ci, pw)
    assert port.list_users() == ref.list_users()
    assert port.lookup_user("u3") == ref.lookup_user("u3")
    for db in (ref, port):
        assert db.update_user("u1", is_superuser=True)
        assert not db.update_user("ghost", password="x")
        assert db.delete_user("u2") and not db.delete_user("u2")
    assert port.lookup_user("u1") == ref.lookup_user("u1")
    assert port.list_users() == ref.list_users()


SECRET = "s3cr3t"
NOW = 1_700_000_000.0
JWT_CASES = {
    "valid": ({"sub": "x"}, {}, "HS256"),
    "superuser": ({"is_superuser": True}, {}, "HS384"),
    "expired": ({"exp": NOW - 1}, {}, "HS256"),
    "at_exp": ({"exp": NOW}, {}, "HS256"),
    "live": ({"exp": NOW + 60, "nbf": NOW - 60}, {}, "HS512"),
    "not_yet": ({"nbf": NOW + 5}, {}, "HS256"),
    "claims_ok": ({"user": "u1", "cid": "c1"},
                  {"user": "%u", "cid": "%c"}, "HS256"),
    "claims_bad": ({"user": "u2"}, {"user": "%u"}, "HS256"),
    "acl": ({"acl": {"pub": ["up/%c"], "sub": ["down/#"]}}, {}, "HS256"),
    "scalar": (42, {}, "HS256"),
}


@pytest.mark.parametrize("case", sorted(JWT_CASES))
def test_jwt_equal_reference(case, monkeypatch):
    """Each token (and a bad signature, the wrong algorithm in the header
    and no password) gets the same verdict and extra in both, under one
    patched clock."""
    payload, claims, alg = JWT_CASES[case]
    for pkg in PKGS:
        monkeypatch.setattr(pkg.authn.time, "time", lambda: NOW)
    ci = {"username": "u1", "clientid": "c1"}
    good = jwt_make(payload, SECRET, alg)
    bad = jwt_make(payload, "other", alg)
    wrong_alg = jwt_make(payload, SECRET, alg,
                         header_alg="HS512" if alg != "HS512" else "HS256")

    def script(pkg):
        a = pkg.authn.JWTAuthenticator(SECRET, alg, verify_claims=claims)
        return [a.authenticate(ci, tok.encode()) for tok in
                (good, bad, wrong_alg, "a.b", "")] + \
            [a.authenticate(ci, None)]
    want, got = both(script)
    assert got == want


def test_jwt_unsupported_algorithm_equal_reference():
    def script(pkg):
        try:
            pkg.authn.JWTAuthenticator(SECRET, "RS256")
        except ValueError as e:
            return str(e)
    want, got = both(script)
    assert got == want and "RS256" in got


class ScriptedHttp:
    """An injected HTTP transport: records each request and answers from
    a script of (status, body) or an exception."""

    def __init__(self, pkg, answers):
        self.pkg, self.answers, self.seen = pkg, list(answers), []

    async def __call__(self, method, url, **kw):
        self.seen.append((method, url, kw.get("json"), kw.get("headers"),
                          kw.get("timeout")))
        ans = self.answers.pop(0)
        if isinstance(ans, Exception):
            raise ans
        status, body = ans
        return self.pkg.http.HttpResponse(status, {}, body)


HTTP_ANSWERS = [
    (200, b'{"result": "allow", "is_superuser": true}'), (200, b'{}'),
    (200, b'{"result": "deny"}'), (200, b'{"result": "ignore"}'),
    (200, b'{"result": "ok"}'), (200, b"not json"), (204, b""),
    (401, b""), (500, b'{"result": "allow"}'), OSError("refused")]


@pytest.mark.parametrize("method", ["post", "get"])
def test_http_authenticator_equal_reference(method):
    """HTTPAuthenticator through an injected transport: the same requests
    (placeholders filled, GET as a query string) and the same verdicts
    for every kind of answer."""
    def script(pkg):
        tr = ScriptedHttp(pkg, HTTP_ANSWERS)
        a = pkg.authn.HTTPAuthenticator(
            "http://auth.local:8080/mqtt/auth", method=method,
            body={"u": "%u", "c": "%c", "p": "%P", "a": "%a", "port": "%p",
                  "fixed": "v", "n": 7},
            headers={"X-K": "1"}, timeout=2.5, transport=tr)
        ci = {"username": "hal", "clientid": "h1",
              "peername": ("10.1.2.3", 5555)}
        got = [run(a.authenticate_async(ci, b"9000"))
               for _ in HTTP_ANSWERS]
        return got, tr.seen, a.authenticate(ci, b"9000")
    want, got = both(script)
    assert got == want


def run_authn(node, clientinfo, password):
    return run(node.hooks.run_fold_async(
        "client.authenticate", (clientinfo,),
        {"ok": True, "password": password}))


CHAIN = {"db": lambda pkg: _db(pkg),
         "db_clientid": lambda pkg: _db(pkg, "clientid"),
         "jwt": lambda pkg: pkg.authn.JWTAuthenticator(SECRET),
         "scram": lambda pkg: scram_users(pkg),
         "http_deny": lambda pkg: pkg.authn.HTTPAuthenticator(
             "http://x/a", transport=ScriptedHttp(
                 pkg, [(200, b'{"result": "deny"}')] * 20)),
         "http_ignore": lambda pkg: pkg.authn.HTTPAuthenticator(
             "http://x/a", transport=ScriptedHttp(pkg, [(404, b"")] * 20))}


def _db(pkg, id_type="username"):
    db = pkg.authn.BuiltinDB(id_type, "plain")
    db.add_user("u1" if id_type == "username" else "c1", "pw")
    return db


@pytest.mark.parametrize("order", [
    ("db",), ("db", "jwt"), ("jwt", "db"), ("scram", "db_clientid"),
    ("http_ignore", "db"), ("http_deny", "db"), ("db", "http_deny"),
    ("scram",), (), ("db_clientid", "http_ignore", "jwt")])
def test_chain_order_equal_reference(order):
    """The chain folds its authenticators in order: the first ok accepts,
    the first deny refuses with 0x86, all-ignore refuses with 0x87; a
    chain with none accepts. Equal verdicts and auth counters in both,
    over credentials each authenticator takes or ignores."""
    token = jwt_make({"is_superuser": True}, SECRET)
    tries = [({"username": "u1", "clientid": "c9"}, b"pw"),
             ({"username": "u1", "clientid": "c1"}, b"no"),
             ({"username": "zz", "clientid": "c1"}, b"pw"),
             ({"username": "zz", "clientid": "zz"}, token.encode()),
             ({"username": None, "clientid": "c1"}, None)]

    def script(pkg):
        node = pkg.node()
        chain = pkg.authn.AuthnChain(node, [CHAIN[k](pkg) for k in order],
                                     enable=True).load()
        out = [run_authn(node, ci, pw) for ci, pw in tries]
        out.append(sorted(getattr(node, "enhanced_authn", {})))
        out.append({k: node.metrics.val(k) for k in (
            "client.auth.success", "client.auth.failure")})
        if order:
            out.append(chain.remove_authenticator(chain.authenticators[0]
                                                  .name))
        out.append(sorted(getattr(node, "enhanced_authn", {})))
        chain.unload()
        out.append(run_authn(node, *tries[1]))
        return out
    want, got = both(script)
    assert got == want


def test_disabled_chain_accepts_equal_reference():
    def script(pkg):
        node = pkg.node()
        pkg.authn.AuthnChain(node, [_db(pkg)], enable=False).load()
        return run_authn(node, {"username": "u1"}, b"bad")
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# authz
# ---------------------------------------------------------------------
WHO = st.recursive(
    st.one_of(st.just("all"),
              st.builds(lambda u: {"username": u}, st.sampled_from(
                  ["u1", "u2", ""])),
              st.builds(lambda c: {"clientid": c}, st.sampled_from(
                  ["c1", "c2"])),
              st.builds(lambda n: {"ipaddr": n}, st.sampled_from(
                  ["10.0.0.0/8", "10.0.0.5", "192.168.0.0/16", "bad/x",
                   "::1/128"]))),
    lambda inner: st.one_of(
        st.builds(lambda xs: {"and": xs}, st.lists(inner, max_size=3)),
        st.builds(lambda xs: {"or": xs}, st.lists(inner, max_size=3))),
    max_leaves=5)
TOPIC = st.sampled_from(["t", "a/b", "a/+", "dev/c1/x", "dev/u1/y",
                         "$SYS/brokers", "a/b/c", "#", "dev/c2/x"])
FILTERS = st.lists(st.one_of(
    st.sampled_from(["#", "a/+", "a/#", "dev/%c/#", "dev/%u/+", "t",
                     "$SYS/#", "+/b"]),
    st.builds(lambda t: {"eq": t}, TOPIC)), max_size=3)
RULE = st.fixed_dictionaries({
    "permit": st.sampled_from(["allow", "deny"]), "who": WHO,
    "action": st.sampled_from(["publish", "subscribe", "all"]),
    "topics": FILTERS})
CLIENT = st.fixed_dictionaries({
    "clientid": st.sampled_from(["c1", "c2", ""]),
    "username": st.sampled_from(["u1", "u2", None]),
    "peername": st.sampled_from([("10.0.0.5", 1234), ("192.168.1.1", 1),
                                 ("::1", 2), None])})


@settings(max_examples=200, deadline=None)
@given(rules=st.lists(RULE, max_size=5), ci=CLIENT,
       action=st.sampled_from(["publish", "subscribe"]), topic=TOPIC)
def test_rules_and_file_source_equal_reference(rules, ci, action, topic):
    """Every drawn rule gives the same verdict alone, and the FileSource
    of all of them in order gives the same one, in both packages."""
    want = [jauthz.Rule(r["permit"], r["who"], r["action"],
                        r["topics"]).check(ci, action, topic) for r in rules]
    got = [tauthz.Rule(r["permit"], r["who"], r["action"],
                       r["topics"]).check(ci, action, topic) for r in rules]
    assert got == want
    assert tauthz.FileSource(rules).authorize(ci, action, topic) == \
        jauthz.FileSource(rules).authorize(ci, action, topic)


def test_rule_validation_equal_reference():
    def script(pkg):
        out = []
        for args in (("maybe",), ("allow", "all", "read")):
            try:
                pkg.authz.Rule(*args)
            except ValueError as e:
                out.append(str(e))
        r = pkg.authz.Rule("allow")
        out.append((r.who, r.action, r.topics))
        return out
    want, got = both(script)
    assert got == want


@pytest.mark.parametrize("acl", [
    None, {}, {"pub": ["up/%c"], "sub": ["down/#"]}, {"all": ["x/%u/#"]},
    {"pub": ["#"]}])
def test_client_acl_source_equal_reference(acl):
    def script(pkg):
        src = pkg.authz.ClientAclSource()
        ci = {"clientid": "c1", "username": "u1", "acl": acl}
        return [src.authorize(ci, a, t)
                for a in ("publish", "subscribe")
                for t in ("up/c1", "up/c2", "down/x", "x/u1/y", "t")]
    want, got = both(script)
    assert got == want


def test_http_source_equal_reference():
    """HTTPSource through an injected transport: equal requests and
    verdicts for every kind of answer."""
    answers = [(200, b'{"result": "allow"}'), (200, b'{"result": "deny"}'),
               (200, b'{"result": "other"}'), (200, b"{}"),
               (200, b"nope"), (204, b""), (403, b""), OSError("x")]

    def script(pkg):
        tr = ScriptedHttp(pkg, answers)
        src = pkg.authz.HTTPSource("http://acl.local/acl", transport=tr,
                                   body={"u": "%u", "c": "%c", "a": "%A",
                                         "t": "%t", "ip": "%a"})
        ci = {"clientid": "c1", "username": "u1",
              "peername": ("10.0.0.5", 1)}
        return [run(src.authorize_async(ci, "publish", f"t/{k}"))
                for k in range(len(answers))], tr.seen
    want, got = both(script)
    assert got == want


CACHE_SCRIPT = [("put", "a", "allow", 0.0), ("put", "b", "deny", 1.0),
                ("get", "a", None, 2.0), ("put", "c", "allow", 3.0),
                ("get", "b", None, 3.5), ("get", "a", None, 4.0),
                ("get", "c", None, 30.0), ("put", "a", "deny", 31.0),
                ("get", "a", None, 40.5), ("get", "c", None, 41.0),
                ("get", "a", None, 41.5), ("drain", None, None, 42.0),
                ("get", "a", None, 42.0)]


@pytest.mark.parametrize("max_size,ttl", [(2, 10.0), (3, 1.0), (32, 60.0)])
def test_authz_cache_equal_reference(max_size, ttl, monkeypatch):
    """The decision cache's LRU eviction and TTL under one scripted clock:
    equal answers at every step."""
    clock = [0.0]
    for pkg in PKGS:
        monkeypatch.setattr(pkg.authz.time, "monotonic", lambda: clock[0])

    def script(pkg):
        c = pkg.authz.AuthzCache(max_size=max_size, ttl=ttl)
        out = []
        for op, topic, verdict, t in CACHE_SCRIPT:
            clock[0] = t
            key = ("publish", topic)
            if op == "put":
                c.put(key, verdict)
            elif op == "get":
                out.append(c.get(key))
            else:
                c.drain()
            out.append(list(c._c))
        return out
    want, got = both(script)
    assert got == want


@pytest.mark.parametrize("no_match", ["allow", "deny"])
@pytest.mark.parametrize("cache", [True, False])
def test_authz_app_equal_reference(no_match, cache):
    """Authz folds its sources in order, falls back to no_match, caches
    per client (hits counted), drops a client's cache on disconnect and
    passes through with no sources."""
    tries = [("c1", "publish", "ok/1"), ("c1", "publish", "ok/1"),
             ("c1", "publish", "other"), ("c2", "subscribe", "acl/x"),
             ("c1", "publish", "other"), ("c2", "subscribe", "acl/x")]

    def script(pkg):
        node = pkg.node()
        az = pkg.authz.Authz(node, [
            pkg.authz.FileSource([{"permit": "allow",
                                   "topics": ["ok/#"]}]),
            pkg.authz.ClientAclSource()],
            no_match=no_match, cache_enable=cache).load()
        out = []
        for k, (cid, action, topic) in enumerate(tries):
            ci = {"clientid": cid, "acl": {"sub": ["acl/#"]}
                  if cid == "c2" else None}
            out.append(run(node.hooks.run_fold_async(
                "client.authorize", (ci, action, topic), "allow")))
            if k == 3:
                node.hooks.run("client.disconnected",
                               ({"clientid": "c1"}, "closed"))
        out.append(node.metrics.val("client.authorize.cache_hit"))
        out.append(sorted(az._caches))
        empty = pkg.node()
        pkg.authz.Authz(empty, [], no_match="deny").load()
        out.append(run(empty.hooks.run_fold_async(
            "client.authorize", ({"clientid": "x"}, "publish", "t"),
            "allow")))
        az.unload()
        out.append(len(node.hooks.lookup("client.authorize")))
        return out
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# Twin nodes over live TCP
# ---------------------------------------------------------------------
SECURE_CONF = {
    "authn": {"enable": True, "chain": [
        {"mechanism": "password_based", "backend": "built_in_database",
         "algorithm": "sha256", "salt_position": "prefix"},
        {"mechanism": "jwt", "secret": SECRET,
         "verify_claims": {"sub": "%c"}},
        {"mechanism": "scram", "algorithm": "sha256",
         "iteration_count": 256}]},
    "authz": {"no_match": "deny", "cache": {"enable": True}, "sources": [
        {"type": "file", "rules": [
            {"permit": "allow", "action": "subscribe",
             "topics": ["device/#", "rules/#"]},
            {"permit": "deny", "action": "publish",
             "topics": ["device/+/forbidden/#"]},
            {"permit": "allow", "action": "publish",
             "topics": ["device/#"]}]},
        {"type": "client_acl"}]},
}
CLIENT_COUNTERS = ("client.authenticate", "client.auth.success",
                   "client.auth.failure", "client.authorize",
                   "client.authorize.cache_hit", "client.connected",
                   "client.connack", "packets.connack.auth_error",
                   "packets.connack.error", "client.disconnected",
                   "client.subscribe", "packets.publish.error",
                   "packets.subscribe.error", "messages.received")


async def stop_batcher(node) -> None:
    if node.publish_batcher is not None:
        await node.publish_batcher.stop()
        node.publish_batcher.close()


def device_node(pkg, conf):
    """A device-route node: the port's engine on the CPU, the reference's
    on JAX's CPU backend."""
    if pkg is REF:
        return JNode(conf, use_device=True, name=NAME)
    return TNode(conf, device="cpu", name=NAME)


async def secure_node(pkg, conf=SECURE_CONF):
    """A node booted by start_apps from SECURE_CONF, its users loaded from
    fixed records: the built-in store's salts from a seeded source in the
    reference, carried into the port by convert.load_auth_records; the
    SCRAM credentials likewise."""
    node = device_node(pkg, conf)
    apps = await node.start_apps()
    db, _jwt, scram = next(a for a in apps
                           if type(a).__name__ == "AuthnChain").authenticators
    ref = jauthn.BuiltinDB("username", "sha256", "prefix")
    for k, user in enumerate(("alice", "bob", "carol")):
        ref._users[user] = {
            "password_hash": jpw.hash_password(
                "sha256", f"pw-{user}".encode(), f"salt{k}", "prefix"),
            "salt": f"salt{k}", "is_superuser": k == 2}
    creds = scram_users(REF)._users
    if pkg is REF:
        db._users.update(ref._users)
        scram._users.update(creds)
    else:
        convert.load_auth_records(builtin=db, users=ref._users,
                                  scram=scram, credentials=creds)
    return node, apps


def record_auth(cl):
    """Record every AUTH packet the client receives."""
    seen = []
    handle = cl._handle

    def rec(pkt):
        if isinstance(pkt, P.Auth):
            seen.append((pkt.reason_code, dict(pkt.properties or {})))
        handle(pkt)
    cl._handle = rec
    return seen


async def _connect(port, **kw):
    """CONNECT; (reason code, or the error) and the client."""
    cl = Client(port=port, **kw)
    try:
        ack = await cl.connect()
        return ack.reason_code, cl
    except MqttError as e:
        return ("refused", cl.connack.reason_code if cl.connack else
                str(e)), cl


async def _secure_script(pkg):
    node, apps = await secure_node(pkg)
    lst = pkg.Listener(node, bind="127.0.0.1", port=0)
    await lst.start()
    port = lst.port
    out = {"apps": [type(a).__name__ for a in apps],
           "enhanced": sorted(getattr(node, "enhanced_authn", {}))}
    clients = []
    orig = jscram._nonce, tscram._nonce
    jscram._nonce = tscram._nonce = lambda: SNONCE
    try:
        # refusals: wrong password (v5 0x86, v3 rc 4), unknown user with
        # no token (0x87), a JWT with a bad signature, an unknown method
        rcs = {}
        for label, kw in (
                ("bad_pw_v5", dict(username="alice", password=b"nope",
                                   proto_ver=C.MQTT_V5)),
                ("bad_pw_v3", dict(username="alice", password=b"nope")),
                ("unknown", dict(username="zed", password=b"x",
                                 proto_ver=C.MQTT_V5)),
                ("jwt_bad_sig", dict(username="zed", password=jwt_make(
                    {"sub": "j1"}, "wrong").encode(), proto_ver=C.MQTT_V5)),
                ("jwt_bad_claim", dict(username="zed", password=jwt_make(
                    {"sub": "other"}, SECRET).encode(),
                    proto_ver=C.MQTT_V5)),
                ("no_method", dict(properties={
                    "authentication_method": "SCRAM-SHA-999"},
                    proto_ver=C.MQTT_V5))):
            rc, cl = await _connect(port, clientid=f"x-{label}", **kw)
            rcs[label] = rc
            await cl.close()
        # a SCRAM CONNECT with a wrong password
        bad = Client(port=port, clientid="s-bad", proto_ver=C.MQTT_V5)
        bad.enable_scram("neo", "wrong")
        seen_bad = record_auth(bad)
        try:
            await bad.connect()
            rcs["scram_bad"] = 0
        except MqttError:
            rcs["scram_bad"] = bad.connack.reason_code if bad.connack \
                else "closed"
        await bad.close()
        out["refused"] = rcs
        out["scram_bad_auth"] = seen_bad
        # accepted: a password user (v5), a JWT user with an acl claim,
        # the SCRAM user, a v3 password user
        sub_rc, sub = await _connect(port, clientid="sub", username="alice",
                                     password=b"pw-alice",
                                     proto_ver=C.MQTT_V5)
        jwt_rc, jw = await _connect(
            port, clientid="j1", username="joe", proto_ver=C.MQTT_V5,
            password=jwt_make({"sub": "j1", "acl": {"pub": ["acl/%c/#"]}},
                              SECRET).encode())
        sc = Client(port=port, clientid="s1", proto_ver=C.MQTT_V5)
        sc.enable_scram("neo", "thematrix")
        seen = record_auth(sc)
        sc_ack = await sc.connect()
        v3_rc, v3 = await _connect(port, clientid="v3", username="bob",
                                   password=b"pw-bob")
        clients += [sub, jw, sc, v3]
        out["accepted"] = [sub_rc, jwt_rc, sc_ack.reason_code, v3_rc,
                           sc.scram_server_ok]
        out["scram_auth"] = list(seen)
        out["scram_connack_props"] = {
            k: v for k, v in (sc_ack.properties or {}).items()
            if k.startswith("authentication")}
        # SUBSCRIBE inside and outside the ACL
        ack = await sub.subscribe([("device/#", P.SubOpts(qos=1)),
                                   ("secret/#", P.SubOpts(qos=1)),
                                   ("rules/x", P.SubOpts(qos=0))])
        out["suback"] = list(ack.reason_codes)
        out["suback_v3"] = list((await v3.subscribe(
            [("other/#", P.SubOpts(qos=1)),
             ("device/v3/#", P.SubOpts(qos=1))])).reason_codes)
        out["routes"] = sorted(node.router.topics()) \
            if hasattr(node.router, "topics") else None
        # PUBLISH: allowed, forbidden, outside every rule, by the JWT
        # client's acl claim (client_acl decides after the file source);
        # the SCRAM user is a superuser: nothing is forbidden to it
        pubacks = []
        for cl, topic in ((sub, "device/d1/forbidden/y"),
                          (sc, "device/d1/x"), (sc, "device/d1/forbidden/x"),
                          (sc, "other/t"), (jw, "device/d2/y"),
                          (jw, "acl/j1/z"), (jw, "acl/j2/z"),
                          (sc, "device/d1/x")):
            a = await cl.publish(topic, f"{topic}".encode(), qos=1)
            pubacks.append(a.reason_code)
        # QoS 0 forbidden and a v3 QoS 1 forbidden: no ack, not delivered
        await sub.publish("device/d3/forbidden/q0", b"q0", qos=0)
        v3.publish_start("device/d3/forbidden/v3", b"v3", qos=1)
        await v3.publish("device/v3/ok", b"v3ok", qos=1)
        out["puback"] = pubacks
        # re-authentication, then a bad one (disconnect 0x87)
        out["reauth"] = await sc.reauthenticate("neo", "thematrix")
        out["scram_auth_after"] = seen[len(out["scram_auth"]):]
        got = []
        for _ in range(4):
            m = await sub.recv(timeout=5)
            got.append((m.topic, m.payload, m.qos))
        await asyncio.sleep(0.2)
        while not sub.messages.empty():
            m = sub.messages.get_nowait()
            got.append((m.topic, m.payload, m.qos))
        out["delivered"] = got
        re_bad = Client(port=port, clientid="s2", proto_ver=C.MQTT_V5)
        re_bad.enable_scram("trin", "ity")
        await re_bad.connect()
        try:
            await re_bad.reauthenticate("trin", "bad", timeout=2)
            out["reauth_bad"] = "ok"
        except (asyncio.TimeoutError, MqttError):
            pass
        await asyncio.wait_for(re_bad.closed.wait(), 5)
        out["reauth_bad"] = getattr(re_bad.disconnect_pkt, "reason_code",
                                    None)
        await re_bad.close()
        for cl in clients:
            await cl.disconnect()
        await asyncio.sleep(0.1)
        out["counters"] = {k: node.metrics.val(k) for k in CLIENT_COUNTERS}
    finally:
        jscram._nonce, tscram._nonce = orig
        for cl in clients:
            await cl.close()
        await lst.stop()
        await stop_batcher(node)
    return out


def test_secured_nodes_over_tcp_equal_reference():
    """Twin nodes booted from one access-control config (built-in users,
    JWT, SCRAM; a file ACL with no_match deny and the client_acl source):
    equal CONNACK codes for every refusal and every login, the same AUTH
    packets for the SCRAM CONNECT, its re-authentication and a refused
    one, equal SUBACK and PUBACK codes, equal deliveries and equal
    client.* counters."""
    want = run(_secure_script(REF))
    got = run(_secure_script(PORT))
    assert got == want
    assert want["refused"]["bad_pw_v5"] == ("refused",
                                            C.RC_BAD_USER_NAME_OR_PASSWORD)
    assert want["refused"]["no_method"] == ("refused",
                                            C.RC_BAD_AUTHENTICATION_METHOD)
    assert want["accepted"][:4] == [0, 0, 0, 0] and want["accepted"][4]
    assert want["reauth"] is True
    assert want["suback"] == [1, C.RC_NOT_AUTHORIZED, 0]
    assert want["puback"][:3] == [C.RC_NOT_AUTHORIZED, 0, 0]
    assert want["scram_auth_after"][-1][0] == C.RC_SUCCESS


DENY_DISCONNECT = dict(SECURE_CONF, authz=dict(SECURE_CONF["authz"],
                                               deny_action="disconnect"))


def test_deny_action_disconnect_equal_reference():
    """authz.deny_action = disconnect: a forbidden PUBLISH closes the
    connection in both, with the same DISCONNECT reason and no ack."""
    async def go(pkg):
        node, _apps = await secure_node(pkg, DENY_DISCONNECT)
        lst = pkg.Listener(node, bind="127.0.0.1", port=0)
        await lst.start()
        try:
            rc, cl = await _connect(lst.port, clientid="d1",
                                    username="alice", password=b"pw-alice",
                                    proto_ver=C.MQTT_V5)
            ok = (await cl.publish("device/a", b"x", qos=1)).reason_code
            cl.publish_start("device/a/forbidden/b", b"x", qos=1)
            await asyncio.wait_for(cl.closed.wait(), 5)
            out = (rc, ok, getattr(cl.disconnect_pkt, "reason_code", None),
                   node.metrics.val("client.authorize"))
            await cl.close()
            return out
        finally:
            await lst.stop()
            await stop_batcher(node)
    want, got = both(lambda pkg: run(go(pkg)))
    assert got == want
