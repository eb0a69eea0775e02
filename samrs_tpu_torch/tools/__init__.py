"""Host-side tools of the PyTorch port: COCO JSON export of instance stacks
(``instance_to_json``) and the prompt evaluation's overlays
(``visualize.overlay_instances``)."""
