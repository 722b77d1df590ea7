"""OMA LwM2M object registry: object/resource definitions + name lookup.

Parity: apps/emqx_gateway/src/lwm2m/emqx_lwm2m_xml_object_db.erl +
emqx_lwm2m_xml_object.erl — the reference loads the OMA DDF XML files
shipped in lwm2m_xml/ into an ets registry and uses it to resolve paths
given by name ("/Device/0/Manufacturer" -> /3/0/0), look up resource
operations, and convert values by resource data type.

Here the core OMA objects (0-7) are compiled in (same definitions the
reference's XML files carry), and `load_xml` accepts OMA DDF XML for
custom objects — stdlib ElementTree, no xmerl analog needed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class ResourceDef:
    rid: int
    name: str
    operations: str        # "R" / "W" / "RW" / "E"
    type: str              # String/Integer/Float/Boolean/Opaque/Time/Objlnk
    multiple: bool = False
    mandatory: bool = False


@dataclass
class ObjectDef:
    oid: int
    name: str
    urn: str = ""
    multiple: bool = False
    resources: dict[int, ResourceDef] = field(default_factory=dict)

    def resource_by_name(self, name: str) -> Optional[ResourceDef]:
        want = name.strip().lower()
        for r in self.resources.values():
            if r.name.lower() == want:
                return r
        return None


def _res(rid, name, ops, rtype, multiple=False, mandatory=False):
    return ResourceDef(rid, name, ops, rtype, multiple, mandatory)


def _obj(oid, name, urn, resources, multiple=False):
    return ObjectDef(oid, name, urn, multiple,
                     {r.rid: r for r in resources})


# Core object definitions per OMA LwM2M TS 1.0 Appendix E (the same set
# the reference ships as lwm2m_xml/*.xml).
_CORE = [
    _obj(0, "LWM2M Security", "urn:oma:lwm2m:oma:0", [
        _res(0, "LWM2M Server URI", "W", "String", mandatory=True),
        _res(1, "Bootstrap Server", "W", "Boolean", mandatory=True),
        _res(2, "Security Mode", "W", "Integer", mandatory=True),
        _res(3, "Public Key or Identity", "W", "Opaque", mandatory=True),
        _res(4, "Server Public Key", "W", "Opaque", mandatory=True),
        _res(5, "Secret Key", "W", "Opaque", mandatory=True),
        _res(6, "SMS Security Mode", "W", "Integer"),
        _res(7, "SMS Binding Key Parameters", "W", "Opaque"),
        _res(8, "SMS Binding Secret Key(s)", "W", "Opaque"),
        _res(9, "LWM2M Server SMS Number", "W", "String"),
        _res(10, "Short Server ID", "W", "Integer"),
        _res(11, "Client Hold Off Time", "W", "Integer"),
    ], multiple=True),
    _obj(1, "LWM2M Server", "urn:oma:lwm2m:oma:1", [
        _res(0, "Short Server ID", "R", "Integer", mandatory=True),
        _res(1, "Lifetime", "RW", "Integer", mandatory=True),
        _res(2, "Default Minimum Period", "RW", "Integer"),
        _res(3, "Default Maximum Period", "RW", "Integer"),
        _res(4, "Disable", "E", "Execute"),
        _res(5, "Disable Timeout", "RW", "Integer"),
        _res(6, "Notification Storing When Disabled or Offline", "RW",
             "Boolean", mandatory=True),
        _res(7, "Binding", "RW", "String", mandatory=True),
        _res(8, "Registration Update Trigger", "E", "Execute",
             mandatory=True),
    ], multiple=True),
    _obj(2, "LWM2M Access Control", "urn:oma:lwm2m:oma:2", [
        _res(0, "Object ID", "R", "Integer", mandatory=True),
        _res(1, "Object Instance ID", "R", "Integer", mandatory=True),
        _res(2, "ACL", "RW", "Integer", multiple=True),
        _res(3, "Access Control Owner", "RW", "Integer", mandatory=True),
    ], multiple=True),
    _obj(3, "Device", "urn:oma:lwm2m:oma:3", [
        _res(0, "Manufacturer", "R", "String"),
        _res(1, "Model Number", "R", "String"),
        _res(2, "Serial Number", "R", "String"),
        _res(3, "Firmware Version", "R", "String"),
        _res(4, "Reboot", "E", "Execute", mandatory=True),
        _res(5, "Factory Reset", "E", "Execute"),
        _res(6, "Available Power Sources", "R", "Integer", multiple=True),
        _res(7, "Power Source Voltage", "R", "Integer", multiple=True),
        _res(8, "Power Source Current", "R", "Integer", multiple=True),
        _res(9, "Battery Level", "R", "Integer"),
        _res(10, "Memory Free", "R", "Integer"),
        _res(11, "Error Code", "R", "Integer", multiple=True,
             mandatory=True),
        _res(12, "Reset Error Code", "E", "Execute"),
        _res(13, "Current Time", "RW", "Time"),
        _res(14, "UTC Offset", "RW", "String"),
        _res(15, "Timezone", "RW", "String"),
        _res(16, "Supported Binding and Modes", "R", "String",
             mandatory=True),
    ]),
    _obj(4, "Connectivity Monitoring", "urn:oma:lwm2m:oma:4", [
        _res(0, "Network Bearer", "R", "Integer", mandatory=True),
        _res(1, "Available Network Bearer", "R", "Integer", multiple=True,
             mandatory=True),
        _res(2, "Radio Signal Strength", "R", "Integer", mandatory=True),
        _res(3, "Link Quality", "R", "Integer"),
        _res(4, "IP Addresses", "R", "String", multiple=True,
             mandatory=True),
        _res(5, "Router IP Addresses", "R", "String", multiple=True),
        _res(6, "Link Utilization", "R", "Integer"),
        _res(7, "APN", "R", "String", multiple=True),
        _res(8, "Cell ID", "R", "Integer"),
        _res(9, "SMNC", "R", "Integer"),
        _res(10, "SMCC", "R", "Integer"),
    ]),
    _obj(5, "Firmware Update", "urn:oma:lwm2m:oma:5", [
        _res(0, "Package", "W", "Opaque", mandatory=True),
        _res(1, "Package URI", "W", "String", mandatory=True),
        _res(2, "Update", "E", "Execute", mandatory=True),
        _res(3, "State", "R", "Integer", mandatory=True),
        _res(4, "Update Supported Objects", "RW", "Boolean"),
        _res(5, "Update Result", "R", "Integer", mandatory=True),
    ]),
    _obj(6, "Location", "urn:oma:lwm2m:oma:6", [
        _res(0, "Latitude", "R", "String", mandatory=True),
        _res(1, "Longitude", "R", "String", mandatory=True),
        _res(2, "Altitude", "R", "String"),
        _res(3, "Uncertainty", "R", "String"),
        _res(4, "Velocity", "R", "Opaque"),
        _res(5, "Timestamp", "R", "Time", mandatory=True),
    ]),
    _obj(7, "Connectivity Statistics", "urn:oma:lwm2m:oma:7", [
        _res(0, "SMS Tx Counter", "R", "Integer"),
        _res(1, "SMS Rx Counter", "R", "Integer"),
        _res(2, "Tx Data", "R", "Integer"),
        _res(3, "Rx Data", "R", "Integer"),
        _res(4, "Max Message Size", "R", "Integer"),
        _res(5, "Average Message Size", "R", "Integer"),
        _res(6, "StartOrReset", "E", "Execute", mandatory=True),
    ]),
]


class ObjectRegistry:
    """Object-definition store with id and name lookup
    (emqx_lwm2m_xml_object_db.erl find_objectid/find_name)."""

    def __init__(self, objects: Optional[list[ObjectDef]] = None):
        self._by_id: dict[int, ObjectDef] = {}
        self._by_name: dict[str, ObjectDef] = {}
        for o in (objects if objects is not None else _CORE):
            self.add(o)

    @classmethod
    def core(cls) -> "ObjectRegistry":
        return cls()

    def add(self, obj: ObjectDef) -> None:
        self._by_id[obj.oid] = obj
        self._by_name[obj.name.lower()] = obj

    def object(self, oid: int) -> Optional[ObjectDef]:
        return self._by_id.get(oid)

    def object_by_name(self, name: str) -> Optional[ObjectDef]:
        return self._by_name.get(name.strip().lower())

    def resource(self, oid: int, rid: int) -> Optional[ResourceDef]:
        o = self._by_id.get(oid)
        return o.resources.get(rid) if o else None

    # ---- path resolution (emqx_lwm2m_cmd_handler path handling) ----
    def resolve_path(self, path: str) -> str:
        """Name segments -> numeric path: "/Device/0/Manufacturer" ->
        "/3/0/0". Numeric segments pass through; raises KeyError when a
        name is unknown."""
        segs = [s for s in str(path).split("/") if s != ""]
        if not segs:
            return "/"
        out: list[str] = []
        obj: Optional[ObjectDef] = None
        if segs[0].isdigit():
            obj = self.object(int(segs[0]))
            out.append(segs[0])
        else:
            obj = self.object_by_name(segs[0])
            if obj is None:
                raise KeyError(f"unknown LwM2M object {segs[0]!r}")
            out.append(str(obj.oid))
        if len(segs) > 1:
            out.append(segs[1])              # instance id is numeric
        if len(segs) > 2:
            if segs[2].isdigit():
                out.append(segs[2])
            else:
                if obj is None:
                    raise KeyError(f"unknown object for {path!r}")
                r = obj.resource_by_name(segs[2])
                if r is None:
                    raise KeyError(
                        f"unknown resource {segs[2]!r} of {obj.name}")
                out.append(str(r.rid))
        out.extend(segs[3:])
        return "/" + "/".join(out)

    def path_name(self, path: str) -> Optional[str]:
        """Numeric path -> "ObjectName/inst/ResourceName" (None when the
        object is unknown)."""
        segs = [s for s in str(path).split("/") if s != ""]
        if not segs or not segs[0].isdigit():
            return None
        obj = self.object(int(segs[0]))
        if obj is None:
            return None
        out = [obj.name]
        if len(segs) > 1:
            out.append(segs[1])
        if len(segs) > 2 and segs[2].isdigit():
            r = obj.resources.get(int(segs[2]))
            out.append(r.name if r else segs[2])
        return "/".join(out)

    def decode_value(self, oid: int, rid: int, raw: Any) -> Any:
        """Convert a text/TLV value by the resource's declared type."""
        r = self.resource(oid, rid)
        if r is None or raw is None:
            return raw
        data = raw
        try:
            if r.type == "Integer" or r.type == "Time":
                if isinstance(data, (bytes, bytearray)):
                    return int.from_bytes(bytes(data), "big",
                                          signed=True) if data else 0
                return int(data)
            if r.type == "Float":
                if isinstance(data, (bytes, bytearray)):
                    import struct as _s
                    if len(data) == 4:
                        return _s.unpack(">f", data)[0]
                    if len(data) == 8:
                        return _s.unpack(">d", data)[0]
                    return 0.0
                return float(data)
            if r.type == "Boolean":
                if isinstance(data, (bytes, bytearray)):
                    return bool(data and data[-1])
                return str(data) in ("1", "true", "True")
            if r.type == "String":
                if isinstance(data, (bytes, bytearray)):
                    return bytes(data).decode("utf-8", "replace")
                return str(data)
        except (ValueError, TypeError):
            return raw
        return raw

    # ---- OMA DDF XML (custom objects; emqx_lwm2m_xml_object_db load) ----
    def load_xml(self, source: str) -> ObjectDef:
        """Parse one OMA DDF XML document (file path or XML string) and
        register the object it defines."""
        import os
        import xml.etree.ElementTree as ET
        if os.path.isfile(source):
            root = ET.parse(source).getroot()
        else:
            root = ET.fromstring(source)
        onode = root.find("Object")
        if onode is None:
            raise ValueError("DDF XML has no <Object> element")
        oid = int(onode.findtext("ObjectID", "0"))
        name = onode.findtext("Name", f"Object{oid}")
        urn = onode.findtext("ObjectURN", "")
        multiple = (onode.findtext("MultipleInstances", "Single")
                    == "Multiple")
        resources = {}
        for item in onode.iter("Item"):
            rid = int(item.get("ID", "0"))
            rname = item.findtext("Name", str(rid))
            ops = item.findtext("Operations", "") or "E"
            rtype = item.findtext("Type", "String") or "String"
            rmult = item.findtext("MultipleInstances", "Single") \
                == "Multiple"
            rmand = item.findtext("Mandatory", "Optional") == "Mandatory"
            resources[rid] = ResourceDef(rid, rname, ops, rtype, rmult,
                                         rmand)
        obj = ObjectDef(oid, name, urn, multiple, resources)
        self.add(obj)
        return obj

    def load_xml_dir(self, dirpath: str) -> int:
        import glob
        import os
        n = 0
        for p in sorted(glob.glob(os.path.join(dirpath, "*.xml"))):
            try:
                self.load_xml(p)
                n += 1
            except (ValueError, OSError):
                continue
        return n
