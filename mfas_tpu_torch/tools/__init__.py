"""Command-line tools of the port: pack_ntu, export_model, predict
(``python -m mfas_tpu_torch.tools.<name>``)."""
