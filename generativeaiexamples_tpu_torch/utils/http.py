"""HTTP client helpers on the standard library's `urllib`.

The JAX package's clients (the playground's chat client, the eval
harness's chain-server client, the voice clients) use `requests`, which
the card's machine does not list. These helpers send the same bytes:
`json_body` is `requests`' `json=` encoding and `multipart_body` its
`data=` / `files=` form encoding (urllib3's layout: the data fields
first, then the files, each part's Content-Disposition then its
Content-Type), so a server sees the same body but for the random
boundary.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
import uuid
from typing import Dict, Mapping, Optional, Sequence, Tuple

# (field name, (filename, bytes, content type or None))
FileField = Tuple[str, Tuple[str, bytes, Optional[str]]]


def json_body(obj) -> bytes:
    return json.dumps(obj, allow_nan=False).encode("utf-8")


def _param(name: str, value: str) -> str:
    value = value.translate({10: "%0A", 13: "%0D", 34: "%22"})
    return f'{name}="{value}"'


def multipart_body(data: Mapping[str, str] = (),
                   files: Sequence[FileField] = (),
                   boundary: str = "") -> Tuple[bytes, str]:
    """(body, content type) of a multipart/form-data request."""
    boundary = boundary or uuid.uuid4().hex
    out = bytearray()
    parts = [(name, None, str(v).encode("utf-8"), None)
             for name, v in dict(data).items()]
    parts += [(name, fname, blob, ctype)
              for name, (fname, blob, ctype) in files]
    for name, fname, blob, ctype in parts:
        disp = "form-data; " + "; ".join(
            _param(k, v) for k, v in (("name", name), ("filename", fname))
            if v is not None)
        lines = [f"Content-Disposition: {disp}"]
        if ctype:
            lines.append(f"Content-Type: {ctype}")
        out += f"--{boundary}\r\n".encode("latin-1")
        out += ("\r\n".join(lines + ["\r\n"])).encode("utf-8")
        out += blob + b"\r\n"
    out += f"--{boundary}--\r\n".encode("latin-1")
    return bytes(out), f"multipart/form-data; boundary={boundary}"


def request(method: str, url: str, *, body: Optional[bytes] = None,
            headers: Optional[Dict[str, str]] = None,
            timeout: float = 30.0) -> Tuple[int, bytes]:
    """(status, body) of one request. An HTTP error status is returned,
    not raised; a connection failure raises urllib.error.URLError (an
    OSError)."""
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def checked(status: int, payload: bytes, url: str) -> bytes:
    """`payload`, or a urllib HTTPError for a status >= 400 (what
    `requests`' raise_for_status raises for)."""
    if status >= 400:
        raise urllib.error.HTTPError(url, status, payload[:200].decode(
            "utf-8", "replace"), None, None)
    return payload
