"""Process-group launchers of the port (`mesh.spawn`)."""
