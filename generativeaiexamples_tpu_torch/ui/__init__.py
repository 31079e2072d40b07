"""The playground: chat client and web server (counterpart of
generativeaiexamples_tpu/ui/)."""

from generativeaiexamples_tpu_torch.ui.chat_client import ChatClient

__all__ = ["ChatClient"]
