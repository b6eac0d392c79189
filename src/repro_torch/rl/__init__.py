"""RL side of the port: env, MLP policy, packed ActorQ actor."""
