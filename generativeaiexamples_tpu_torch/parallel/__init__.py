"""Parallelism substrate of the port: the device mesh over rank processes
(`mesh`)."""
