"""Host service layer of the port. Only the parsed-batch form the engine's
fused front door takes (``wire.WireBatch``) is ported so far."""
