"""Command-line tools of the port (`python -m paddle_tpu_torch.tools.<name>`):
conv1x1_fuse_probe, the counterpart of tools/conv1x1_fuse_probe.py."""
