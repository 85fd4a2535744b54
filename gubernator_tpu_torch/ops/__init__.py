"""Device-side operations of the port: table, batch layout, decision math,
decide kernel, slot write and the single-device engine."""
