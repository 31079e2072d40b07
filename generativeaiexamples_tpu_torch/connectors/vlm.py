"""Vision-language connector: OpenAI-compatible multimodal chat.

The port's copy of generativeaiexamples_tpu/connectors/vlm.py on the
standard library's `urllib.request` (the JAX copy uses `requests`), with
the JAX client's request bodies. The multimodal pipeline asks it whether
an image is a chart (the reference's Neva role), to linearize a chart
into a data table (DePlot's role), or to describe an image; all three
ride the same image+text chat API, so one client covers them.
"""

from __future__ import annotations

import base64
from typing import Optional

from generativeaiexamples_tpu_torch.connectors.openai_http import _Client


class VLMClient(_Client):
    def __init__(self, base_url: str, model: str = "", api_key: str = "",
                 timeout: float = 120.0):
        super().__init__(base_url, api_key, timeout)
        self.model = model

    def describe(self, image_bytes: bytes, prompt: str,
                 image_format: str = "jpeg", max_tokens: int = 512) -> str:
        b64 = base64.b64encode(image_bytes).decode()
        body = {
            "model": self.model,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": prompt},
                {"type": "image_url", "image_url": {
                    "url": f"data:image/{image_format};base64,{b64}"}},
            ]}],
            "max_tokens": max_tokens,
        }
        return self._post("/chat/completions",
                           body)["choices"][0]["message"]["content"]

    def is_chart(self, image_bytes: bytes, image_format: str = "jpeg") -> bool:
        """Is this a chart, graph or plot?"""
        out = self.describe(
            image_bytes,
            "Is this image a chart, graph or plot? Answer yes or no only.",
            image_format, max_tokens=8)
        return "yes" in out.lower()

    def chart_to_table(self, image_bytes: bytes,
                       image_format: str = "jpeg") -> str:
        """Linearize a chart into a data table."""
        return self.describe(
            image_bytes,
            "Generate the underlying data table for this chart.",
            image_format)


def make_vlm(config) -> Optional[VLMClient]:
    """A client of `vlm.server_url`, or None when it is empty (image
    enrichment off)."""
    if not config.vlm.server_url:
        return None
    return VLMClient(config.vlm.server_url, model=config.vlm.model_name)
