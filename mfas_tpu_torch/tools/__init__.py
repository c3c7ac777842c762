"""Command-line tools of the port (``python -m mfas_tpu_torch.tools.<name>``):
pack_ntu, export_model, predict, convert_torchvision, search_report,
parity_kit, profile_step."""
