"""The distributed layer: a mesh of shards and the shuffle join over it."""
