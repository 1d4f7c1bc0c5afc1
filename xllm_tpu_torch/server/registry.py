"""Instance registry + heartbeats (cluster control plane).

A copy of ``xllm_tpu/server/registry.py`` on the port's stdlib transport
(``server/http.py``) instead of aiohttp.

Counterpart of the reference's XServiceClient + etcd registration
(reference xllm/core/runtime/xservice_client.h:38-75, common/etcd_client.h:30,
docs/en/features/xllm_service_overview.md): serving instances register
themselves with a registry, heartbeat periodically, and routers list the
live set (the reference delegates failover/global scheduling to
xLLM-service on top of exactly this primitive). A small HTTP registry
provides the same register/heartbeat/watch surface; swap the transport for
etcd/redis in a real deployment.
"""

from __future__ import annotations

import threading
import time
import uuid

from xllm_tpu_torch.server import http as web
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def make_registry_app(ttl_s: float = 10.0) -> web.Application:
    """The registry service: register / heartbeat / list-live-instances."""
    instances: dict[str, dict] = {}

    async def register(request: web.Request) -> web.Response:
        body = await request.json()
        iid = body.get("instance_id") or "inst-" + uuid.uuid4().hex[:12]
        instances[iid] = {
            "instance_id": iid,
            "address": body.get("address", ""),
            "model": body.get("model", ""),
            "role": body.get("role", "mixed"),  # prefill|decode|mixed
            "registered_at": time.time(),
            "last_heartbeat": time.time(),
            "meta": body.get("meta", {}),
        }
        logger.info("registered instance %s (%s)", iid, body.get("address"))
        return web.json_response({"instance_id": iid, "ttl_s": ttl_s})

    async def heartbeat(request: web.Request) -> web.Response:
        iid = request.match_info["iid"]
        inst = instances.get(iid)
        if inst is None:
            return web.json_response({"error": "unknown instance"}, status=404)
        inst["last_heartbeat"] = time.time()
        return web.json_response({"ok": True})

    async def deregister(request: web.Request) -> web.Response:
        instances.pop(request.match_info["iid"], None)
        return web.json_response({"ok": True})

    async def list_instances(request: web.Request) -> web.Response:
        now = time.time()
        role = request.query.get("role")
        live = [
            i
            for i in instances.values()
            if now - i["last_heartbeat"] <= ttl_s
            and (role is None or i["role"] == role)
        ]
        return web.json_response({"instances": live})

    app = web.Application()
    app.router.add_post("/registry/register", register)
    app.router.add_post("/registry/heartbeat/{iid}", heartbeat)
    app.router.add_post("/registry/deregister/{iid}", deregister)
    app.router.add_get("/registry/instances", list_instances)
    return app


class InstanceClient:
    """Serving-instance side: register + background heartbeats.

    Reference XServiceClient::init + register_instance + heartbeat thread
    (xservice_client.h:38-75).
    """

    def __init__(
        self,
        registry_url: str,
        address: str,
        model: str,
        role: str = "mixed",
        heartbeat_interval_s: float = 3.0,
        meta: dict | None = None,
    ):
        self.registry_url = registry_url.rstrip("/")
        self.address = address
        self.model = model
        self.role = role
        self.meta = meta or {}
        self.heartbeat_interval_s = heartbeat_interval_s
        self.instance_id: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _post(self, path: str, payload: dict | None = None) -> dict:
        import json
        import urllib.request

        req = urllib.request.Request(
            self.registry_url + path,
            data=json.dumps(payload or {}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read().decode())

    def start(self) -> str:
        out = self._post(
            "/registry/register",
            {
                "address": self.address,
                "model": self.model,
                "role": self.role,
                "meta": self.meta,
            },
        )
        self.instance_id = out["instance_id"]
        self._thread = threading.Thread(
            target=self._beat, daemon=True, name="registry-heartbeat"
        )
        self._thread.start()
        return self.instance_id

    def _beat(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                self._post(f"/registry/heartbeat/{self.instance_id}")
            except Exception as e:  # registry outage is non-fatal
                logger.warning("heartbeat failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.instance_id:
            try:
                self._post(f"/registry/deregister/{self.instance_id}")
            except Exception:
                pass
