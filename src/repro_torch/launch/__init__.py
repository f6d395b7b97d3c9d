"""Launchers of the port: the distributed MCE CLI (`mce_run`) and the
long-lived service (`mce_service`)."""
