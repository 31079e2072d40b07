"""Playground launcher: `python -m generativeaiexamples_tpu_torch.ui`.

Counterpart of generativeaiexamples_tpu/ui/__main__.py with its flags:
--host / --port / --chain-server (APP_SERVERURL) / --model-name
(APP_MODELNAME) / --config / -v. The voice buttons light up when the
config's `[voice]` section names ASR / TTS endpoints.
"""

from __future__ import annotations

import argparse
import logging
import os


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--chain-server",
                    default=os.environ.get("APP_SERVERURL",
                                           "http://localhost:8081"),
                    help="chain server base URL")
    ap.add_argument("--model-name",
                    default=os.environ.get("APP_MODELNAME", "local"))
    ap.add_argument("--config", default=None, help="YAML/JSON config file")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from generativeaiexamples_tpu_torch.config.wizard import load_config
    from generativeaiexamples_tpu_torch.obs import tracing
    from generativeaiexamples_tpu_torch.ui.chat_client import ChatClient
    from generativeaiexamples_tpu_torch.ui.server import (
        PlaygroundServer, run_server)

    cfg = load_config(args.config)
    tracing.setup(cfg)
    client = ChatClient(args.chain_server, args.model_name)
    from generativeaiexamples_tpu_torch.streaming.asr import (
        create_voice_clients)

    asr, tts = create_voice_clients(cfg)
    if asr or tts:
        logging.info("voice: asr=%s tts=%s", bool(asr), bool(tts))
    voice_cfg = getattr(cfg, "voice", None)
    server = PlaygroundServer(
        client, asr=asr, tts=tts,
        voice_sample_rate=voice_cfg.sample_rate if voice_cfg else 16000)
    logging.info("playground on %s:%d -> chain server %s",
                 args.host, args.port, args.chain_server)
    run_server(server, args.host, args.port)


if __name__ == "__main__":
    main()
