"""Chaos-wrapped gRPC channel: wire faults between client and sidecar.

The chaos substrate (FaultInjector, ChaosCloudProvider,
CapacityDrought) stops at the process boundary; this wrapper extends it to
the one boundary that is actually a wire. ``ChaosChannel`` decorates a real
``grpc.Channel`` so every unary RPC consults a seeded
``utils.chaos.WireFaultInjector`` before/after delivery:

- drop        -> UNAVAILABLE raised client-side, the server never sees the
                 request (blackholed packet / connection reset on send)
- delay       -> injector.delay_seconds of added latency before delivery
                 (with a short client deadline this manufactures
                 DEADLINE_EXCEEDED without a stalled server)
- duplicate   -> the request is delivered twice back to back; the second
                 delivery must be served by the server's request-digest
                 dedupe cache, not re-applied (a re-apply would corrupt
                 the delta session and fail the digest handshake loudly)
- disconnect  -> the request is delivered and APPLIED, the response is
                 discarded and UNAVAILABLE raised — the lost-response
                 desync the resilient client must heal by retrying the
                 identical bytes into the dedupe cache

Server-kill faults live one level up (the soak harness and the simulator
restart the real server process/listener); the channel only models the
wire. Everything is deterministic per seed: the injector burns a fixed
number of RNG draws per attempt, so the same RPC sequence sees the same
fault schedule."""

from __future__ import annotations

import threading
import time
from typing import Optional

import grpc

from ..utils.chaos import WireFaultInjector


class InjectedRpcError(grpc.RpcError):
    """Synthetic transport failure carrying the grpc status surface the
    client's error handling reads (code()/details())."""

    def __init__(self, code: grpc.StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _ChaosFuture:
    """Minimal grpc.Future surface (result/done/cancel/add_done_callback)
    over a daemon thread running one chaos-wrapped attempt — the hedged
    client path needs .future() on the chaos channel too."""

    def __init__(self, fn):
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._callbacks: list = []

        def run():
            try:
                self._result = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in result()
                self._exc = e
            self._done.set()
            for cb in self._callbacks:
                try:
                    cb(self)
                except Exception:  # noqa: BLE001 — callbacks never propagate
                    pass

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="chaos-rpc")
        self._thread.start()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise grpc.FutureTimeoutError()
        if self._exc is not None:
            raise self._exc
        return self._result

    def done(self) -> bool:
        return self._done.is_set()

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise grpc.FutureTimeoutError()
        return self._exc

    def cancel(self) -> bool:
        return False  # the attempt already left the station

    def add_done_callback(self, cb) -> None:
        if self._done.is_set():
            cb(self)
        else:
            self._callbacks.append(cb)


class _ChaosCall:
    """unary_unary multicallable wrapper: one fault draw per ATTEMPT (a
    retry is a fresh attempt with its own verdict, exactly like a real
    flaky wire)."""

    def __init__(self, inner, injector: WireFaultInjector):
        self._inner = inner
        self._injector = injector

    def _attempt(self, request, timeout):
        inj = self._injector
        faults = inj.draw()
        if "delay" in faults:
            if timeout is not None and inj.delay_seconds >= timeout:
                # the wire is slower than the caller's patience: the
                # client deadline fires mid-flight, the request never
                # lands (this is how a short deadline manufactures
                # DEADLINE_EXCEEDED deterministically)
                time.sleep(timeout)
                raise InjectedRpcError(
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    "injected wire fault: delayed past the client "
                    "deadline")
            time.sleep(inj.delay_seconds)
        if "drop" in faults:
            raise InjectedRpcError(grpc.StatusCode.UNAVAILABLE,
                                   "injected wire fault: request dropped")
        if "duplicate" in faults:
            # retransmit racing its original: both deliveries reach the
            # server; the caller sees the second response
            self._inner(request, timeout=timeout)
            return self._inner(request, timeout=timeout)
        response = self._inner(request, timeout=timeout)
        if "disconnect" in faults:
            # the server applied the request; the response died on the wire
            raise InjectedRpcError(
                grpc.StatusCode.UNAVAILABLE,
                "injected wire fault: disconnected before the response")
        return response

    def __call__(self, request, timeout: Optional[float] = None):
        return self._attempt(request, timeout)

    def future(self, request, timeout: Optional[float] = None):
        return _ChaosFuture(lambda: self._attempt(request, timeout))


class ChaosChannel:
    """grpc.Channel decorator injecting seeded wire faults (see module
    docstring). Only the unary_unary surface the sidecar protocol uses is
    wrapped; everything else delegates."""

    def __init__(self, channel: grpc.Channel, injector: WireFaultInjector):
        self._channel = channel
        self.injector = injector

    def unary_unary(self, method, request_serializer=None,
                    response_deserializer=None, **kwargs):
        inner = self._channel.unary_unary(
            method, request_serializer=request_serializer,
            response_deserializer=response_deserializer, **kwargs)
        return _ChaosCall(inner, self.injector)

    def close(self) -> None:
        self._channel.close()

    def __getattr__(self, item):
        return getattr(self._channel, item)


def chaos_channel_factory(injector: WireFaultInjector, options=None):
    """Channel factory for the fleet client (SolverSession.enable_fleet):
    every replica the router dials gets the SAME seeded injector, so a
    failover mid-chaos-window keeps drawing from one deterministic fault
    stream — the simulator's ledger digest stays replica-count-invariant."""
    def factory(address: str) -> grpc.Channel:
        from .server import GRPC_OPTIONS
        ch = grpc.insecure_channel(address,
                                   options=(options if options is not None
                                            else GRPC_OPTIONS))
        return ChaosChannel(ch, injector)
    return factory
