"""Chat client for the chain server's REST API.

Counterpart of generativeaiexamples_tpu/ui/chat_client.py on `urllib`
(utils/http.py) instead of `requests`, with the same request bodies:
SSE `data: ` + JSON per line for /generate, multipart /documents upload,
/search, list and delete, and W3C trace context injected on every call
(the port's obs/tracing.py). The playground server proxies through it;
tests and harnesses use it as the programmatic client.
"""

from __future__ import annotations

import json
import logging
import mimetypes
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Generator, List, Optional, Union

from generativeaiexamples_tpu_torch.obs import tracing
from generativeaiexamples_tpu_torch.utils import http

_LOG = logging.getLogger(__name__)

# What `requests` raises for a failed call, an error status past
# raise_for_status, or a body that is not JSON.
_REQUEST_ERRORS = (OSError, ValueError)


class ChatClient:
    """A client for the chain server."""

    def __init__(self, server_url: str, model_name: str = "local") -> None:
        self.server_url = server_url.rstrip("/")
        self._model_name = model_name

    @property
    def model_name(self) -> str:
        return self._model_name

    # -- internals ---------------------------------------------------------

    def _headers(self, span) -> Dict[str, str]:
        """The active span's context as W3C headers."""
        headers = {"accept": "application/json"}
        try:
            tracing.inject_context(headers)
        except Exception:  # tracing must never break the request path
            pass
        return headers

    def _call(self, method: str, path: str, body=None, timeout: float = 30,
              params: Optional[Dict[str, str]] = None):
        """(status, body bytes, url) of one call with trace headers and
        an optional JSON body."""
        url = f"{self.server_url}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = self._headers(None)
        data = None
        if body is not None:
            data = http.json_body(body)
            headers["Content-Type"] = "application/json"
        status, out = http.request(method, url, body=data, headers=headers,
                                   timeout=timeout)
        return status, out, url

    # -- API surface -------------------------------------------------------

    def health(self) -> bool:
        try:
            status, _ = http.request("GET", f"{self.server_url}/health",
                                     timeout=5)
            return status == 200
        except OSError:
            return False

    def search(self, prompt: str, top_k: int = 4
               ) -> List[Dict[str, Union[str, float]]]:
        """Search for relevant documents."""
        with tracing.span("search", {"prompt": prompt[:256]}):
            try:
                status, out, url = self._call(
                    "POST", "/search", {"query": prompt, "top_k": top_k})
                body = json.loads(http.checked(status, out, url))
                # chain server returns {"chunks": [...]}
                return body.get("chunks", body) if isinstance(body, dict) else body
            except _REQUEST_ERRORS as e:
                _LOG.error("search failed against %s: %s", self.server_url, e)
                return []

    def predict(self, query: str, use_knowledge_base: bool,
                num_tokens: int = 1024,
                stop: Optional[List[str]] = None,
                ) -> Generator[Optional[str], None, None]:
        """Stream a response: text chunks, then None at the end (an error
        string in place of the answer when the call fails, never a
        raise)."""
        data = {
            "messages": [{"role": "user", "content": query}],
            "use_knowledge_base": use_knowledge_base,
            "max_tokens": num_tokens,
        }
        if stop:
            data["stop"] = stop
        with tracing.span("predict",
                          {"use_knowledge_base": use_knowledge_base}) as sp:
            built = ""
            try:
                req = urllib.request.Request(
                    f"{self.server_url}/generate", data=http.json_body(data),
                    method="POST",
                    headers={**self._headers(sp),
                             "Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    for chunk in resp:
                        raw = chunk.decode("utf-8").rstrip("\r\n")
                        if not raw.startswith("data: "):
                            continue
                        payload = raw[6:]
                        try:
                            frame = json.loads(payload)
                        except json.JSONDecodeError as e:
                            raise ValueError(
                                f"Invalid response json: {raw}") from e
                        choices = frame.get("choices", [])
                        if choices:
                            finish = choices[0].get("finish_reason")
                            if finish == "[DONE]":
                                break
                            text = choices[0].get("message", {}).get(
                                "content", "")
                            built += text
                            yield text
            except _REQUEST_ERRORS as e:
                _LOG.error("predict failed against %s: %s",
                           self.server_url, e)
                yield ("Failed to get response from /generate endpoint of "
                       "chain-server. Check if the server is up. Refer to "
                       "chain-server logs for details.")
            if sp is not None:
                try:
                    sp.set_attribute("response", built[:2048])
                except Exception:
                    pass
            yield None  # end-of-response sentinel

    def upload_documents(self, file_paths: List[str]) -> None:
        """Upload documents to the knowledge base. Raises ValueError with
        the server's message on failure."""
        with tracing.span("upload_documents", {"n": len(file_paths)}):
            for fpath in file_paths:
                mime, _ = mimetypes.guess_type(fpath)
                with open(fpath, "rb") as fh:
                    body, ctype = http.multipart_body(files=[(
                        "file", (os.path.basename(fpath), fh.read(), mime))])
                status, out = http.request(
                    "POST", f"{self.server_url}/documents", body=body,
                    headers={**self._headers(None), "Content-Type": ctype},
                    timeout=600)
                if status >= 400:
                    try:
                        parsed = json.loads(out)
                        msg = parsed.get("message", parsed.get("detail"))
                    except Exception:
                        msg = out.decode("utf-8", "replace")[:200]
                    raise ValueError(str(msg or "Failed to upload document"))

    def delete_documents(self, file_name: str) -> Union[str, dict]:
        """Delete a document by filename."""
        with tracing.span("delete_documents", {"filename": file_name}):
            try:
                status, out, url = self._call(
                    "DELETE", "/documents", params={"filename": file_name})
                return json.loads(http.checked(status, out, url))
            except _REQUEST_ERRORS as e:
                _LOG.error("delete failed for %s: %s", file_name, e)
                return ""

    def get_uploaded_documents(self) -> List[str]:
        """List the knowledge base's documents."""
        with tracing.span("get_uploaded_documents"):
            try:
                status, out, _ = self._call("GET", "/documents", timeout=600)
            except urllib.error.URLError as e:
                # Chain server may start after the playground; don't crash.
                _LOG.error("documents endpoint unreachable: %s", e)
                return []
            if status >= 500:
                raise ValueError(json.loads(out).get(
                    "message", "Failed to get uploaded documents"))
            return json.loads(out).get("documents", [])
