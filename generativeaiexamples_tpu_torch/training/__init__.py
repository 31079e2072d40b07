"""Single-device training: SFT, LoRA and the retriever fine-tune
(counterpart of generativeaiexamples_tpu/training/)."""
