"""The selective scan of the SSM mixers over a prompt: CUDA kernel
(``csrc/``) and wrapper (``ops``); its plain version is
``repro_torch.models.ssm._scan``."""
