"""The decoder model (the port of ``repro.models``), dense GQA slots only."""
