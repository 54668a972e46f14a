"""Scene representation and procedural builders."""
