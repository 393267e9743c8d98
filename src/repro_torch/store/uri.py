"""The ``store://`` task-payload grammar of the columnar track store.

The one definition of the grammar: the reader, the segment processor,
the screen workers and the scheduling policies
(:func:`repro_torch.runtime.policies.locality_key`) all import it from
here.  URIs name read selections inside ``run_job`` task payloads::

    store://<root>                          # whole store
    store://<root>#track=<track_id>         # one track
    store://<root>#shard=<shard_id>         # one shard (all rows)
    store://<root>#shard=<shard_id>&rows=<a>:<b>   # row range in a shard
"""

from __future__ import annotations

import urllib.parse

__all__ = ["STORE_URI_PREFIX", "is_store_uri", "make_store_uri",
           "parse_store_uri"]

STORE_URI_PREFIX = "store://"


def is_store_uri(path: object) -> bool:
    return isinstance(path, str) and path.startswith(STORE_URI_PREFIX)


def make_store_uri(root: str, **selector: str) -> str:
    """``make_store_uri('/d/store', shard='s00001', rows='0:8')``."""
    frag = urllib.parse.urlencode(dict(sorted(selector.items())))
    return STORE_URI_PREFIX + root + ("#" + frag if frag else "")


def parse_store_uri(uri: str) -> tuple[str, dict[str, str]]:
    """-> (store root, selector dict)."""
    if not is_store_uri(uri):
        raise ValueError(f"not a store uri: {uri!r}")
    rest = uri[len(STORE_URI_PREFIX):]
    root, _, frag = rest.partition("#")
    sel = dict(urllib.parse.parse_qsl(frag)) if frag else {}
    unknown = set(sel) - {"track", "shard", "rows"}
    if unknown:
        raise ValueError(f"unknown store selector key(s) {sorted(unknown)} "
                         f"in {uri!r}")
    if "rows" in sel and "shard" not in sel:
        raise ValueError(f"rows= needs shard= in {uri!r}")
    return root, sel
