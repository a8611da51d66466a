"""Corpus-sharded search: the placement of the corpus over a 1-D mesh
(:mod:`.sharding`) and the wave collectives of the sharded beam engine
(:mod:`.collectives`)."""
