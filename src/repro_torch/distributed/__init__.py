"""Sharded serving: the layout rules and the rank's slice
(``sharding``), the rank's collectives (``parallel``) and the rank
launcher (``spawn``)."""
